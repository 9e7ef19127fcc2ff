"""zamba2-7b — hybrid: Mamba2 backbone + one SHARED attention block applied
periodically (weights reused at every application). [arXiv:2411.15242]
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,              # total blocks; every `attn_period`-th is the shared attn block
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,            # MHA in the shared block
    head_dim=112,
    d_ff=14_336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,               # d_inner = 7168
    ssm_head_dim=64,
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_chunk=256,
    attn_period=7,              # one shared attn block per 7 blocks (11 applications)
    source="arXiv:2411.15242; unverified",
)
