"""Dense building blocks in PyTorch: RMS and layer norms, RoPE and
whisper's sinusoidal positions, GQA attention with QKV bias / qk-norm,
sliding window and logit softcap, and cross-attention over a separate
key/value input or, in a decode step, over precomputed cross K/V; gated MLPs (SiLU or tanh-approximate GELU) and whisper's
plain biased MLP, tied embeddings with gemma's scale and final softcap,
and the layer-group rematerialisation of ``cfg.remat``.

Plain functions on tensors; parameters are nested dicts built from the
``*_param_specs`` declarations, with the JAX package's layouts and
canonical keys. Dtypes follow ``repro.models.layers``: activations stay in
the parameters' dtype (bf16), norms and RoPE compute in f32, logits are a
bf16 product cast to f32. Attention goes through
:mod:`repro_torch.kernels.ops`: plain version on the CPU, the hand-written
kernels on the card.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

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


def layer_norm(x, scale, bias, eps: float):
    """Layer norm computed in f32, scale and bias in f32, cast back."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def norm_param_specs(cfg: ModelConfig, dim: Optional[int] = None):
    d = dim or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": spec((d,), ("embed",), "ones"),
                "bias": spec((d,), ("embed",), "zeros")}
    return {"scale": spec((d,), ("embed",), "zeros")}  # (1 + scale)


def apply_norm(p, x, cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
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


def sinusoidal_positions(positions, d_model: int):
    """Whisper's sinusoidal embedding in f32, ``[sin, cos]`` over
    frequencies ``exp(-i log(1e4) / (half - 1))``. positions: (B, S) ->
    (B, S, d_model)."""
    half, dev = d_model // 2, positions.device
    step = torch.log(torch.tensor(10_000.0, device=dev)) / (half - 1)
    freq = torch.exp(-torch.arange(half, dtype=torch.float32, device=dev)
                     * step)
    angle = positions[..., None].float() * freq
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


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


def _project_qkv(p, cfg: ModelConfig, x, kv_x):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", kv_x, p["wk"])
    v = torch.einsum("btd,dhk->bthk", kv_x, p["wv"])
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
               kv_x=None, cache=None, cache_pos: Optional[int] = None,
               use_rope=True):
    """Project, rope, (cache update), attend, out-project.

    q comes from ``x``; k and v from ``kv_x`` when it is given
    (cross-attention, keys at positions 0..T-1 and never rotated), else
    from ``x``. cache: optional {"k": (B, T, K, D), "v": ...}; the new keys
    and values are written at ``cache_pos`` (a host int) IN PLACE, which
    saves a copy of the cache per token (the JAX version returns an updated
    copy). The ``s`` new queries sit at positions ``cache_pos ..
    cache_pos + s - 1``: one goes to K2; several go to K1 with that query
    offset on the card and to the port of the reference's XLA branch on
    the CPU. Returns ``(out, kv)``: the cache dict when one was given, else
    the freshly projected (post-rope) {"k", "v"} the prefill uses to build
    one.
    """
    q, k, v = _project_qkv(p, cfg, x, x if kv_x is None else kv_x)
    scale = cfg.attn_scale if cfg.attn_scale is not None \
        else cfg.resolved_head_dim ** -0.5
    softcap = cfg.attn_logit_softcap
    if use_rope and cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        if kv_x is None:        # self-attention: keys at their own positions
            k = rope(k, positions, cfg.rope_theta)
    if cache is not None:
        s = x.shape[1]
        ck, cv = cache["k"], cache["v"]
        ck[:, cache_pos:cache_pos + s] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + s] = v.to(cv.dtype)
        kv_out = cache
        if s == 1:
            out = kops.decode_attention(q[:, 0], ck, cv, cache_pos,
                                        scale=scale, window=window,
                                        softcap=softcap)[:, None]
        elif x.is_cuda:
            # K1 with the queries at cache_pos.., over the cache's first
            # cache_pos + s rows, read in place
            t = cache_pos + s
            out = kops.flash_attention(q, ck[:, :t], cv[:, :t],
                                       causal=causal, window=window,
                                       softcap=softcap, scale=scale,
                                       q_chunk=cfg.attn_q_chunk,
                                       q_off=cache_pos)
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


def cross_decode(p, cfg: ModelConfig, h, cross_k, cross_v):
    """A decode step's cross-attention over precomputed K/V (B, T, K, D),
    as whisper's and llama-3.2-vision's references compute it
    (``repro/models/whisper.py:104-115``, ``vision.py:70-77``): q alone is
    projected, unrotated, scaled by head_dim^-1/2 (not ``cfg.attn_scale``),
    over every key, non-causal and with no cap: K2 at ``pos = T - 1``.
    h: (B, 1, d_model)."""
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    out = kops.decode_attention(q[:, 0], cross_k, cross_v,
                                cross_k.shape[1] - 1,
                                scale=cfg.resolved_head_dim ** -0.5)
    return torch.einsum("bshk,hkd->bsd", out[:, None], p["wo"])


# --------------------------------------------------------------------- mlp

def mlp_param_specs(cfg: ModelConfig, d_ff: int):
    d = cfg.d_model
    if cfg.norm == "layernorm":  # whisper's plain MLP with biases
        return {
            "wi": spec((d, d_ff), ("embed", "mlp")),
            "bi": spec((d_ff,), ("mlp",), "zeros"),
            "wo": spec((d_ff, d), ("mlp", "embed")),
            "bo": spec((d,), ("embed",), "zeros"),
        }
    return {
        "wi_gate": spec((d, d_ff), ("embed", "mlp")),
        "wi_up": spec((d, d_ff), ("embed", "mlp")),
        "wo": spec((d_ff, d), ("mlp", "embed")),
    }


def _act(cfg: ModelConfig, x):
    """The activation: tanh-approximate GELU (gemma2's gate, whisper's
    MLP), else SiLU."""
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def mlp_apply(p, cfg: ModelConfig, x):
    """Gated MLP: act(x W_gate) * (x W_up), then W_o; or, with ``wi``,
    whisper's plain one: act(x W_i + b_i) W_o + b_o, each bias added to
    the bf16 product as the reference adds it."""
    if "wi" in p:
        return _act(cfg, x @ p["wi"] + p["bi"]) @ p["wo"] + p["bo"]
    return (_act(cfg, x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo"]


# -------------------------------------------------------------- embeddings

def embed_param_specs(cfg: ModelConfig):
    p = {"embedding": spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           "embed", scale=1.0)}
    if not cfg.tie_embeddings:
        p["unembed"] = spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return p


def embed_apply(p, cfg: ModelConfig, tokens):
    x = p["embedding"].to(torch.bfloat16)[tokens]
    if cfg.family == "dense" and cfg.post_norms:
        # gemma scales by sqrt(d_model), the constant first rounded to x's
        # dtype as the reference's jnp.asarray(d ** 0.5, x.dtype): 68.0,
        # not 67.88, at gemma2-27b's 4608
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return x


def unembed_apply(p, cfg: ModelConfig, x):
    """bf16 product, then f32 (as the JAX einsum then astype), then the
    final logit softcap where the config has one."""
    if cfg.tie_embeddings:
        logits = (x @ p["embedding"].t()).float()
    else:
        logits = (x @ p["unembed"]).float()
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


# ------------------------------------------------------------------ remat

# the ops a matmul, an einsum and ``@`` lower to: the outputs ``"dots"``
# keeps, as jax.checkpoint_policies.checkpoint_dots keeps dot_general's
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOT_OPS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _wants_grad(tree) -> bool:
    if torch.is_tensor(tree):
        return tree.requires_grad
    if isinstance(tree, dict):
        return any(_wants_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_wants_grad(v) for v in tree)
    return False


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, one layer group of a forward, under ``cfg.remat`` as
    the reference's ``jax.checkpoint(fn, policy=remat_policy(cfg))``
    (``repro/models/layers.py:382-387``).

    It runs directly when ``cfg.remat == "none"`` or no gradient is wanted
    (grad mode off, or no tensor in ``args`` requires one). Otherwise it
    runs under a non-reentrant ``torch.utils.checkpoint``: ``"dots"`` keeps
    the matmuls' outputs and recomputes the rest in the backward, any other
    value (``"full"``) keeps nothing inside the group but its inputs. The
    group then runs twice in a forward and backward, kernels included.
    The groups draw no random numbers, so no RNG state is kept."""
    if cfg.remat == "none" or not torch.is_grad_enabled() \
            or not _wants_grad(args):
        return fn(*args)
    context_fn = ckpt.noop_context_fn
    if cfg.remat == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           preserve_rng_state=False, context_fn=context_fn)
