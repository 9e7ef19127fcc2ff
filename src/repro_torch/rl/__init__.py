"""RLVR substrate in PyTorch: rollout and the synthetic math data pipeline."""
