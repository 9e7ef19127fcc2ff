"""Dense building blocks in PyTorch: RMS norm, RoPE, GQA attention with
QKV bias / qk-norm, SwiGLU MLP, tied embeddings.

Plain functions on tensors; parameters are nested dicts built from the
``*_param_specs`` declarations, with the JAX package's layouts and
canonical keys. Dtypes follow ``repro.models.layers``: activations stay in
the parameters' dtype (bf16), norms and RoPE compute in f32, logits are a
bf16 product cast to f32. Attention goes through
:mod:`repro_torch.kernels.ops`: plain version on the CPU, the hand-written
kernels on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import xla_attention
from repro_torch.models.common import spec

# ------------------------------------------------------------------- norms


def rms_norm(x, scale, eps: float):
    """RMS norm with the (1 + scale) convention, computed in f32."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def norm_param_specs(cfg: ModelConfig, dim: Optional[int] = None):
    return {"scale": spec((dim or cfg.d_model,), ("embed",), "zeros")}


def apply_norm(p, x, cfg: ModelConfig):
    return rms_norm(x, p["scale"], cfg.norm_eps)


# ------------------------------------------------------------------- rope

def rope(x, positions, theta: float):
    """Rotate-half RoPE in f32. x: (B, S, H, D); positions: (B, S) or (S,)."""
    if theta <= 0:
        return x
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    angle = positions[..., None].float() * freq          # (B, S, half)
    cos = torch.cos(angle)[:, :, None, :]
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- attention

def attn_param_specs(cfg: ModelConfig):
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": spec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": spec((d, k, hd), ("embed", "kv_heads", "head_dim")),
        "wv": spec((d, k, hd), ("embed", "kv_heads", "head_dim")),
        "wo": spec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = spec((h, hd), ("heads", "head_dim"), "zeros")
        p["bk"] = spec((k, hd), ("kv_heads", "head_dim"), "zeros")
        p["bv"] = spec((k, hd), ("kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = spec((hd,), ("head_dim",), "zeros")
        p["k_norm"] = spec((hd,), ("head_dim",), "zeros")
    return p


def _project_qkv(p, cfg: ModelConfig, x):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", x, p["wk"])
    v = torch.einsum("btd,dhk->bthk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attention_core(q, k, v, *, causal: bool, window: int,
                   softcap: Optional[float], scale: float, q_chunk: int):
    """Prefill attention, positions from 0. q: (B, S, H, D); k, v:
    (B, T, K, D). K1 on the card, its plain version on the CPU, under an
    autograd Function whose backward is that of the JAX package's XLA
    branch (``kernels/ops.py``), the branch ``grpo.py`` differentiates."""
    return kops.flash_attention(q, k, v, causal=causal, window=window,
                                softcap=softcap, scale=scale, q_chunk=q_chunk)


def attn_apply(p, cfg: ModelConfig, x, *, positions, causal=True, window=0,
               cache=None, cache_pos: Optional[int] = None):
    """Project, rope, (cache update), attend, out-project.

    cache: optional {"k": (B, T, K, D), "v": ...}; the new keys and values
    are written at ``cache_pos`` (a host int) IN PLACE, which saves a copy
    of the cache per token (the JAX version returns an updated copy).
    Returns ``(out, kv)``: the cache dict when one was given, else the
    freshly projected (post-rope) {"k", "v"} the prefill uses to build one.
    """
    q, k, v = _project_qkv(p, cfg, x)
    scale = cfg.attn_scale if cfg.attn_scale is not None \
        else cfg.resolved_head_dim ** -0.5
    softcap = cfg.attn_logit_softcap
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if cache is not None:
        s = x.shape[1]
        ck, cv = cache["k"], cache["v"]
        ck[:, cache_pos:cache_pos + s] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + s] = v.to(cv.dtype)
        kv_out = cache
        if s == 1 and not window and softcap is None:
            out = kops.decode_attention(q[:, 0], ck, cv, cache_pos,
                                        scale=scale)[:, None]
        elif x.is_cuda:
            raise NotImplementedError(
                "K2 decodes one token without window or softcap; multi-token "
                "cache writes and gemma2 decode on the card are not ported "
                "(ROADMAP.md, Queue 1: gemma2 decode)")
        else:
            kv_mask = torch.arange(ck.shape[1], device=x.device) \
                <= cache_pos + s - 1
            out = xla_attention(q, ck, cv, q_positions=positions,
                                kv_mask=kv_mask, causal=causal,
                                window=window, softcap=softcap, scale=scale,
                                q_chunk=cfg.attn_q_chunk)
    else:
        kv_out = {"k": k, "v": v}
        out = attention_core(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale,
                             q_chunk=cfg.attn_q_chunk)
    proj = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return proj, kv_out


# --------------------------------------------------------------------- mlp

def mlp_param_specs(cfg: ModelConfig, d_ff: int):
    d = cfg.d_model
    return {
        "wi_gate": spec((d, d_ff), ("embed", "mlp")),
        "wi_up": spec((d, d_ff), ("embed", "mlp")),
        "wo": spec((d_ff, d), ("mlp", "embed")),
    }


def mlp_apply(p, cfg: ModelConfig, x):
    """SwiGLU MLP."""
    return (F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo"]


# -------------------------------------------------------------- embeddings

def embed_param_specs(cfg: ModelConfig):
    p = {"embedding": spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           "embed", scale=1.0)}
    if not cfg.tie_embeddings:
        p["unembed"] = spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return p


def embed_apply(p, cfg: ModelConfig, tokens):
    return p["embedding"].to(torch.bfloat16)[tokens]


def unembed_apply(p, cfg: ModelConfig, x):
    """bf16 product, then f32 (as the JAX einsum then astype)."""
    if cfg.tie_embeddings:
        return (x @ p["embedding"].t()).float()
    return (x @ p["unembed"]).float()
