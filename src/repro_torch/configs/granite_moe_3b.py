"""granite-moe-3b-a800m — MoE 40 experts top-8, narrow experts.
[hf:ibm-granite/granite-3.0-1b-a400m-base family]
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=0,                     # no dense branch
    vocab_size=49_155,
    num_experts=40,
    experts_per_token=8,
    moe_d_ff=512,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
