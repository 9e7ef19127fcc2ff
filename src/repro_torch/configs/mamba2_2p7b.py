"""mamba2-2.7b — SSD (state-space duality), attention-free. [arXiv:2405.21060]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    vocab_size=50_280,
    d_ff=0,                 # attention-free, no FFN blocks: mamba2 mixer only
    ssm_state=128,
    ssm_expand=2,           # d_inner = 5120
    ssm_head_dim=64,        # 80 SSD heads
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_chunk=256,
    norm="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)
