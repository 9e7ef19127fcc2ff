"""Qwen3-235B-A22B — the paper's large MoE evaluation model (Tab. 1)."""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="paper-qwen3-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151_936,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=1536,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-235B-A22B",
)
