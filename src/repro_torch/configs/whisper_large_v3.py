"""whisper-large-v3 — encoder-decoder audio backbone. Conv/mel frontend is a
STUB: ``input_specs()`` provides precomputed frame embeddings. [arXiv:2212.04356]
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,              # decoder layers
    encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,            # MHA
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    is_encoder_decoder=True,
    encoder_seq=1500,           # 30 s of audio after conv frontend (stubbed)
    act="gelu",
    norm="layernorm",
    norm_eps=1e-5,
    tie_embeddings=True,
    rope_theta=0.0,             # whisper uses learned/sinusoidal positions, no RoPE
    source="arXiv:2212.04356; unverified",
)
