"""RLVR substrate in PyTorch: rollout, the synthetic math data pipeline,
rewards and the GRPO objective."""
