"""llama-3.2-vision-90b — dense decoder with cross-attention image layers.
Vision tower is a STUB: ``input_specs()`` provides precomputed patch embeddings
already projected to d_model. [hf:meta-llama/Llama-3.2-11B-Vision]
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=128_256,
    cross_attn_period=5,        # every 5th layer is a cross-attn image layer
    vision_seq=1601,            # 1 tile x (40x40 patches + cls), stubbed
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
