"""gemma2-27b — dense, local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36_864,
    vocab_size=256_000,
    sliding_window=4096,
    local_global_period=2,        # every 2nd layer global, others local
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    attn_scale=(4608 // 32) ** -0.5,   # query_pre_attn_scalar = d_model/num_heads
    post_norms=True,
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2408.00118; hf",
)
