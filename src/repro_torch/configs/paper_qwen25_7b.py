"""Qwen2.5-7B-Instruct — the paper's dense evaluation model (Tab. 1)."""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="paper-qwen2.5-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-7B-Instruct",
)
