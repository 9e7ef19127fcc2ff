"""arctic-480b — MoE 128 experts top-2 with a parallel dense residual MLP.
[hf:Snowflake/snowflake-arctic-base]
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,                  # dense residual branch width
    vocab_size=32_000,
    num_experts=128,
    experts_per_token=2,
    moe_d_ff=4864,
    dense_residual=True,
    source="hf:Snowflake/snowflake-arctic-base; hf",
)
