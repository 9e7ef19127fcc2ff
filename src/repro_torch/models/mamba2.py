"""Mamba2 (SSD, state-space duality) mixer and attention-free LM.

Mirrors ``repro.models.mamba2``: the chunked SSD algorithm of
arXiv:2405.21060 for a prefill, an O(1) recurrent step for decode. The
decode cache is a fixed-size (conv window, SSM state) pair per layer,
``{"conv": (L, B, conv_dim, K-1), "ssm": (L, B, H, P, N) f32, "pos": int}``;
``pos`` stays a host int.

The prefill's chunk scan goes through :func:`repro_torch.kernels.ops.ssd`,
the way the dense attention goes through ``kops.flash_attention``: on the
card it is K3 (``kernels/csrc/ssd.cu``), on the CPU its plain version
``ref_ssd``. The JAX package's ``mixer_apply`` calls ``ssd_chunked``
instead, whose intra-chunk scores are rounded to x's dtype; K3 keeps them
in f32, as the TPU kernel does. The convolutions and the decode step are
plain PyTorch, as they are plain jnp in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import layer_view, spec, stack_specs
from repro_torch.models.layers import (
    apply_norm,
    embed_apply,
    embed_param_specs,
    norm_param_specs,
    rms_norm,
    unembed_apply,
)

# ------------------------------------------------------------------ params


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def in_proj_dim(cfg: ModelConfig) -> int:
    return 2 * cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state + cfg.ssm_nheads


def mixer_param_specs(cfg: ModelConfig):
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    return {
        "in_proj": spec((d, in_proj_dim(cfg)), ("embed", "ssm_inner")),
        "conv_w": spec((conv_dim(cfg), cfg.ssm_conv), ("conv_dim", None)),
        "conv_b": spec((conv_dim(cfg),), ("conv_dim",), "zeros"),
        "A_log": spec((h,), ("ssm_heads",), "ssm_a", dtype=torch.float32),
        "D": spec((h,), ("ssm_heads",), "ones", dtype=torch.float32),
        "dt_bias": spec((h,), ("ssm_heads",), "dt_bias", dtype=torch.float32),
        "norm": spec((di,), ("ssm_inner",), "zeros"),
        "out_proj": spec((di, d), ("ssm_inner", "embed")),
    }


def layer_param_specs(cfg: ModelConfig):
    return {"ln": norm_param_specs(cfg), "mixer": mixer_param_specs(cfg)}


def param_specs(cfg: ModelConfig):
    return {
        "embed": embed_param_specs(cfg),
        "layers": stack_specs(layer_param_specs(cfg), cfg.num_layers),
        "ln_f": norm_param_specs(cfg),
    }


# --------------------------------------------------------------------- SSD

def ssd_decode(state, x, dt, A, B, C):
    """Single-token SSD update, IN PLACE on ``state``.

    state: (b, h, p, n) f32; x: (b, h, p); dt: (b, h); B, C: (b, g, n).
    Returns (y (b, h, p) in x's dtype, state). The JAX version returns a
    new state; updating in place saves writing a second copy of it per
    layer and token (2.68 GB over the 64 layers at mamba2-2.7b, batch 16).
    """
    b, h, p = x.shape
    n = B.shape[-1]
    rep = h // B.shape[1]
    Bh = B.repeat_interleave(rep, 1).float()                      # (b,h,n)
    Ch = C.repeat_interleave(rep, 1).float()
    dtf = dt.float()
    state.mul_(torch.exp(dtf * A[None, :])[:, :, None, None])
    # state += (dt x) outer B, as a batched rank-1 product into the state
    flat = state.view(b * h, p, n)
    flat.baddbmm_((dtf[:, :, None] * x.float()).reshape(b * h, p, 1),
                  Bh.reshape(b * h, 1, n))
    y = torch.einsum("bhn,bhpn->bhp", Ch, state)
    return y.to(x.dtype), state


# ---------------------------------------------------------------- conv1d

def causal_conv(x, w, b):
    """Depthwise causal conv. x: (B, S, C); w: (C, K). An explicit K-tap
    multiply-add in f32, as the JAX version: ``F.conv1d`` would run through
    cuDNN, in TF32 by default on the card."""
    k, s = w.shape[1], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    wf = w.float()
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s, :].float() * wf[:, i]
    return F.silu(out + b.float()).to(x.dtype)


def conv_decode(conv_state, x_new, w, b):
    """One conv step, IN PLACE on ``conv_state`` (B, C, K-1); x_new: (B, C).
    Returns (out (B, C), conv_state)."""
    window = torch.cat([conv_state, x_new[:, :, None]], 2)        # (B, C, K)
    wf = w.float()
    out = window[:, :, 0].float() * wf[:, 0]
    for i in range(1, w.shape[1]):
        out = out + window[:, :, i].float() * wf[:, i]
    conv_state.copy_(window[:, :, 1:])
    return F.silu(out + b.float()).to(x_new.dtype), conv_state


# ------------------------------------------------------------------- mixer

def _split_in_proj(cfg: ModelConfig, zxbcdt):
    di, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:di + di + 2 * gn],
            zxbcdt[..., di + di + 2 * gn:])


def _split_xbc(cfg: ModelConfig, xBC):
    di, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    return xBC[..., :di], xBC[..., di:di + gn], xBC[..., di + gn:]


def mixer_apply(p, cfg: ModelConfig, x, cache=None,
                return_state: bool = False):
    """Full-sequence mamba2 mixer. x: (B, S, d_model).

    Returns (out, new_cache). With ``cache`` ({"conv", "ssm"} of one layer)
    the input must be one step (S == 1) and both entries are updated IN
    PLACE (the dense ``attn_apply`` writes its K/V the same way). With
    ``return_state`` in full-sequence mode, the final (conv, ssm) states
    are returned so a prefill can seed a decode cache.
    """
    b, s, _ = x.shape
    h, pdim, n, g = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_ngroups
    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"])
    z, xBC, dt_raw = _split_in_proj(cfg, zxbcdt)
    A = -torch.exp(p["A_log"].float())
    dt = F.softplus(dt_raw.float() + p["dt_bias"])

    if cache is None:
        xBC_raw = xBC
        xBC = causal_conv(xBC, p["conv_w"], p["conv_b"])
        xs, B, C = _split_xbc(cfg, xBC)
        xs = xs.reshape(b, s, h, pdim)
        y, final_state = kops.ssd(xs, dt, A, B.reshape(b, s, g, n),
                                  C.reshape(b, s, g, n), chunk=cfg.ssm_chunk)
        y = y + p["D"][None, None, :, None].to(y.dtype) * xs
        new_cache = None
        if return_state:
            kc = cfg.ssm_conv - 1
            conv_state = xBC_raw[:, s - kc:, :].transpose(1, 2).contiguous()
            new_cache = {"conv": conv_state, "ssm": final_state}
    else:
        xBC_step, _ = conv_decode(cache["conv"], xBC[:, 0], p["conv_w"],
                                  p["conv_b"])
        xs, B, C = _split_xbc(cfg, xBC_step[:, None, :])
        y1, _ = ssd_decode(cache["ssm"], xs[:, 0].reshape(b, h, pdim),
                           dt[:, 0], A, B[:, 0].reshape(b, g, n),
                           C[:, 0].reshape(b, g, n))
        y = y1[:, None] + p["D"][None, None, :, None].to(y1.dtype) \
            * xs.reshape(b, 1, h, pdim)
        new_cache = cache

    y = y.reshape(b, s, cfg.d_inner)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.norm_eps)
    return torch.einsum("bse,ed->bsd", y, p["out_proj"]), new_cache


def block_apply(p, cfg: ModelConfig, x, cache=None,
                return_state: bool = False):
    h = apply_norm(p["ln"], x, cfg)
    out, new_cache = mixer_apply(p["mixer"], cfg, h, cache, return_state)
    return x + out, new_cache


# ----------------------------------------------------------------- model

def forward(params, cfg: ModelConfig, tokens, return_cache: bool = False):
    """Teacher-forcing forward. tokens: (B, S) -> (logits, aux[, cache])."""
    b, s = tokens.shape
    x = embed_apply(params["embed"], cfg, tokens)
    cache = None
    if return_cache:
        # filled layer by layer: no list of per-layer states to stack
        cache = {"conv": torch.empty((cfg.num_layers, b, conv_dim(cfg),
                                      cfg.ssm_conv - 1), dtype=x.dtype,
                                     device=x.device),
                 "ssm": torch.empty((cfg.num_layers, b, cfg.ssm_nheads,
                                     cfg.ssm_head_dim, cfg.ssm_state),
                                    dtype=torch.float32, device=x.device),
                 "pos": s}
    for i in range(cfg.num_layers):
        x, st = block_apply(layer_view(params["layers"], i), cfg, x,
                            return_state=return_cache)
        if return_cache:
            cache["conv"][i] = st["conv"]
            cache["ssm"][i] = st["ssm"]
    x = apply_norm(params["ln_f"], x, cfg)
    logits = unembed_apply(params["embed"], cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if return_cache:
        return logits, aux, cache
    return logits, aux


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """Decode cache: conv window + SSM state per layer. O(1) in max_len."""
    l, h, pdim, n = cfg.num_layers, cfg.ssm_nheads, cfg.ssm_head_dim, \
        cfg.ssm_state
    return {
        "conv": spec((l, batch, conv_dim(cfg), cfg.ssm_conv - 1),
                     ("layers", "cache_batch", "conv_dim", None), "zeros"),
        "ssm": spec((l, batch, h, pdim, n),
                    ("layers", "cache_batch", "ssm_heads", None, None),
                    "zeros", dtype=torch.float32),
    }


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """One decode step. tokens: (B, 1); cache conv/ssm updated in place.
    Returns (logits, cache with pos + 1)."""
    x = embed_apply(params["embed"], cfg, tokens)
    for i in range(cfg.num_layers):
        x, _ = block_apply(layer_view(params["layers"], i), cfg, x,
                           cache={"conv": cache["conv"][i],
                                  "ssm": cache["ssm"][i]})
    x = apply_norm(params["ln_f"], x, cfg)
    logits = unembed_apply(params["embed"], cfg, x)
    return logits, {"conv": cache["conv"], "ssm": cache["ssm"],
                    "pos": int(cache["pos"]) + 1}
