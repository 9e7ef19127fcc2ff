"""Qwen3-30B-A3B — the paper's mid-size MoE evaluation model (Tab. 1)."""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="paper-qwen3-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151_936,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B",
)
