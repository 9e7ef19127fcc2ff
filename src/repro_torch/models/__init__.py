"""Model substrate in PyTorch: declarative param specs and the dense
decoder family (qwen2 / qwen3 / deepseek-coder shapes)."""
