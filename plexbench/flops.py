"""The yardstick's arithmetic: the card's peaks, each kernel's operations
and bytes from its shapes, and a dense model's FLOPs.

A kernel's bound is max(FLOP / peak FLOP/s, bytes / peak bytes/s): each
input byte read once and each output byte written once, the FLOPs those of
the pairs its masks keep (2 a multiply-add).
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense bf16, at the full 700 W power limit
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def causal_pairs(s: int, t: int) -> int:
    """Query-key pairs of a causal prefill whose S queries are the last S
    of T keys (query i at position T - S + i sees keys 0..T - S + i)."""
    off = t - s
    return s * (off + 1) + s * (s - 1) // 2


def k1(b: int, s: int, t: int, h: int, kh: int, d: int, itemsize: int = 2):
    """K1, the flash-attention forward: (FLOPs, bytes). QK^T and PV over the
    causal pairs; q read and the output written once, K and V read once."""
    flops = 4 * b * h * d * causal_pairs(s, t)
    nbytes = (2 * b * s * h * d + 2 * b * t * kh * d) * itemsize
    return flops, nbytes


def k2(b: int, h: int, kh: int, d: int, pos: int, itemsize: int = 2):
    """K2, one decode step's attention over the live keys 0..pos:
    (FLOPs, bytes). q read and the output written once, the live K and V
    rows read once."""
    live = pos + 1
    return (4 * b * h * d * live,
            2 * b * h * d * itemsize + 2 * b * live * kh * d * itemsize)


def matmul_params(cfg: dict) -> int:
    """Parameters that a token's forward multiplies: every layer's
    projections and the output matrix (the embedding lookup is free)."""
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    h, k, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                cfg["head_dim"])
    per_layer = d * (h + 2 * k) * hd + h * hd * d + 3 * d * f
    return cfg["num_hidden_layers"] * per_layer + d * v


def attention_flops(cfg: dict, pairs: int) -> int:
    """QK^T and PV over ``pairs`` query-key pairs, in every layer."""
    return 4 * cfg["num_attention_heads"] * cfg["head_dim"] * \
        cfg["num_hidden_layers"] * pairs


def forward_flops(cfg: dict, rows: int, seq: int) -> int:
    """A forward pass over ``rows`` sequences of ``seq`` tokens: 2NT plus
    causal attention."""
    return rows * (2 * matmul_params(cfg) * seq
                   + attention_flops(cfg, causal_pairs(seq, seq)))


def update_flops(cfg: dict, rows: int, seq: int) -> int:
    """Forward and backward (6NT plus attention's three passes); the
    recomputed forward is not counted."""
    return 3 * forward_flops(cfg, rows, seq)


def generate_flops(cfg: dict, rows: int, prompt: int, new: int) -> int:
    """The prefill (2NT over the prompt) and each decode token (2N plus
    attention over the live keys)."""
    total = forward_flops(cfg, rows, prompt)
    for pos in range(prompt, prompt + new):
        total += rows * (2 * matmul_params(cfg)
                         + attention_flops(cfg, pos + 1))
    return total
