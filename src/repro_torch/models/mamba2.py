"""Mamba2 (SSD, state-space duality) mixer and attention-free LM.

Mirrors ``repro.models.mamba2``: the chunked SSD algorithm of
arXiv:2405.21060 for a prefill, an O(1) recurrent step for decode. The
decode cache is a fixed-size (conv window, SSM state) pair per layer,
``{"conv": (L, B, conv_dim, K-1), "ssm": (L, B, H, P, N) f32, "pos": int}``;
``pos`` stays a host int.

The full-sequence chunk scan (a prefill, and the training forward) goes
through :func:`repro_torch.kernels.ops.ssd`, the way the dense attention
goes through ``kops.flash_attention``: on the card it is K3
(``kernels/csrc/ssd.cu``), on the CPU its plain version ``ref_ssd``. The
JAX package's ``mixer_apply`` calls ``ssd_chunked`` instead, whose
intra-chunk scores are rounded to x's dtype; K3 keeps them in f32, as the
TPU kernel does. :func:`ssd_chunked` is ported here as it stands: it is
what ``ops.ssd``'s backward differentiates, as ``jax.grad`` differentiates
it in the JAX package. The convolutions and the decode step are plain
PyTorch, as they are plain jnp in the JAX package. The training forward
rematerialises each block under ``cfg.remat`` (``layers.remat``), as the
reference checkpoints its scanned block.

Over a slice of several devices (a ``ctx``, ``models/layers.py``) the
stored layouts are the reference's ``RULES_TP``: ``in_proj``'s columns
(``ssm_inner``), the conv weights and the conv cache (``conv_dim``), and
``A_log``, ``D``, ``dt_bias`` and the ssm cache (``ssm_heads``) split over
the slice, as do ``norm`` and ``out_proj``'s rows (``ssm_inner``). The
first two split *concatenated* dims (z | x | B | C | dt, and x | B | C)
evenly, so their blocks do not follow the heads; :func:`mixer_apply`
computes on them as GSPMD would reshard them (:func:`_mixer_apply_tp`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import sharding as shd
from repro_torch.models.common import spec, stack_specs
from repro_torch.models.layers import (
    Ctx,
    add,
    apply_norm,
    embed_apply,
    embed_param_specs,
    norm_param_specs,
    per_row,
    remat,
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

def segsum(x):
    """x: (..., l) -> (..., l, l) with out[i, j] = sum_{j<k<=i} x_k (else
    -inf)."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, out, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """Chunked SSD scan, as ``repro.models.mamba2.ssd_chunked``: the
    intra-chunk scores are rounded to x's dtype before their product with
    x, and a ragged tail is zero-padded (dt = 0: decay 1, no state update).

    x: (b, s, h, p); dt: (b, s, h) (post-softplus); A: (h,) (negative);
    B, C: (b, s, g, n). Returns (y (b, s, h, p), final_state (b, h, p, n)
    f32). Differentiable: ``kernels/ops.py``'s K3 Function takes its
    gradient from this function's autograd.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    s_orig = s
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    rep = h // g

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, 3)
    Cc = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, 3)

    dA = (dtc * A[None, None, None, :]).float()                   # (b,nc,l,h)
    dA_cs = torch.cumsum(dA, dim=2)

    # intra-chunk (diagonal blocks): quadratic within a chunk
    L = torch.exp(segsum(dA.transpose(-1, -2)))                  # (b,nc,h,l,l)
    scores = torch.einsum("bclhn,bcshn->bchls", Cc.float(), Bc.float())
    scores = scores * L * dtc.transpose(-1, -2)[:, :, :, None, :]
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores.to(x.dtype), xc)

    # chunk summary states: S_c = sum_j exp(dA_j+1..L) dt_j B_j x_j^T
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)        # (b,nc,l,h)
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", Bc.float(),
                          (decay_states * dtc).float(), xc.float())

    # inter-chunk recurrence over nc chunks
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                   # (b,nc,h)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) \
        if initial_state is None else initial_state.float()
    entry = []
    for c in range(nc):
        entry.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    entry_states = torch.stack(entry, 1)                         # (b,nc,h,p,n)

    # off-diagonal contribution from the incoming state
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", Cc.float(), entry_states,
                         torch.exp(dA_cs))
    y = (y_diag.float() + y_off).reshape(b, s, h, p)
    return y[:, :s_orig].to(x.dtype), state


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
                return_state: bool = False, ctx: Optional[Ctx] = None):
    """Full-sequence mamba2 mixer. x: (B, S, d_model).

    Returns (out, new_cache). With ``cache`` ({"conv", "ssm"} of one layer)
    the input must be one step (S == 1) and both entries are updated IN
    PLACE (the dense ``attn_apply`` writes its K/V the same way). With
    ``return_state`` in full-sequence mode, the final (conv, ssm) states
    are returned so a prefill can seed a decode cache. With ``ctx``, over
    the slice (:func:`_mixer_apply_tp`).
    """
    if ctx is not None:
        return _mixer_apply_tp(p, cfg, x, cache, return_state, ctx)
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


# ------------------------------------------------------ mixer over a slice

def _in_proj_tp(w, xs, ctx: Ctx):
    """z | xBC | dt on every device (steps 1-2 of
    :func:`_mixer_apply_tp`): each device's product by its block of
    ``in_proj``'s columns, all-gathered."""
    parts = [torch.einsum("bsd,de->bse", xr, w.locals[r])
             for r, xr in enumerate(xs)]
    if not shd.splits(w, 1):
        return parts
    return ctx.all_gather(parts, -1)


def _block_range(leaf, r: int, dim: int, size: int) -> slice:
    """Device ``r``'s index range along ``dim`` of a leaf of ``size``
    there: its block where the dim splits, else all of it."""
    if not shd.splits(leaf, dim):
        return slice(0, size)
    n = leaf.locals[r].shape[dim]
    b = leaf.sharding.block(r, leaf.dim())[dim]
    return slice(b * n, (b + 1) * n)


def _mixer_apply_tp(p, cfg: ModelConfig, xs, cache, return_state, ctx: Ctx):
    """:func:`mixer_apply` over the slice, on the reference's stored
    layouts. ``xs``: the input on every device; ``cache``: {"conv", "ssm":
    per-device lists of the layer's local blocks}. Each device

    1. multiplies by its block of ``in_proj``'s columns;
    2. all-gathers the product, so it holds z, xBC and dt whole;
    3. runs the depthwise conv on its ``conv_dim`` block of xBC (a decode
       step: on its block of the conv cache, in place);
    4. all-gathers the conv output, taking its heads' x and the whole B
       and C (``ssm_ngroups`` is 1, ``groups`` is not split);
    5. runs K3 at its local heads (a decode step: ``ssd_decode`` in place
       on its block of the ssm cache), then the ``D`` skip;
    6. gates and norms its block of d_inner, the f32 sum of squares
       all-reduced so the RMS is over the whole d_inner;
    7. multiplies by its rows of ``out_proj``, and an all-reduce sums the
       partial products.

    Returns the per-device outputs and, for a prefill with
    ``return_state``, {"conv", "ssm": per-device local blocks}."""
    p = ctx.view(p)
    devs = ctx.devices
    h, pdim, n, g = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_ngroups
    if not all(shd.splits(p[k], 0) for k in ("A_log", "norm", "out_proj")):
        raise ValueError(
            f"{cfg.name}: {h} SSD heads over a slice of {ctx.n} devices; "
            f"the mixer runs over a slice whose size divides the heads")
    di, gn, cdim = cfg.d_inner, g * n, conv_dim(cfg)
    hl = p["A_log"].locals[0].shape[0]
    il = hl * pdim
    b, s, _ = xs[0].shape
    zx = _in_proj_tp(p["in_proj"], xs, ctx)
    cw, cb = p["conv_w"], p["conv_b"]
    conv_split = shd.splits(cw, 0)
    crange = [_block_range(cw, r, 0, cdim) for r in range(len(devs))]
    convs, states = [], []
    for r, z in enumerate(zx):
        xbc = z[..., di:di + cdim][..., crange[r]]
        if cache is None:
            convs.append(causal_conv(xbc, cw.locals[r], cb.locals[r]))
            if return_state:
                kc = cfg.ssm_conv - 1
                states.append(xbc[:, s - kc:, :].transpose(1, 2)
                              .contiguous())
        else:
            convs.append(conv_decode(cache["conv"][r], xbc[:, 0],
                                     cw.locals[r], cb.locals[r])[0][:, None])
    xbc = ctx.all_gather(convs, -1) if conv_split else convs
    ys, ssm_states = [], []
    for r, z in enumerate(zx):
        hr = _block_range(p["A_log"], r, 0, h)
        x_r = xbc[r][..., hr.start * pdim:hr.stop * pdim]
        B, C = xbc[r][..., di:di + gn], xbc[r][..., di + gn:]
        dt = F.softplus(z[..., di + cdim:][..., hr].float()
                        + p["dt_bias"].locals[r])
        A = -torch.exp(p["A_log"].locals[r].float())
        xh = x_r.reshape(b, s, hl, pdim)
        if cache is None:
            y, final = kops.ssd(xh, dt, A, B.reshape(b, s, g, n),
                                C.reshape(b, s, g, n), chunk=cfg.ssm_chunk)
            ssm_states.append(final)
        else:
            y, _ = ssd_decode(cache["ssm"][r], xh[:, 0], dt[:, 0], A,
                              B[:, 0].reshape(b, g, n),
                              C[:, 0].reshape(b, g, n))
            y = y[:, None]
        y = y + p["D"].locals[r][None, None, :, None].to(y.dtype) * xh
        zr = z[..., hr.start * pdim:hr.stop * pdim]
        ys.append(y.reshape(b, s, il) * F.silu(zr.float()).to(y.dtype))
    # the gated RMS norm over the whole d_inner: f32 sums of squares
    sq = ctx.all_reduce([torch.sum(torch.square(y.float()), dim=-1,
                                   keepdim=True) for y in ys])
    outs = []
    for r, y in enumerate(ys):
        yn = (y.float() * torch.rsqrt(sq[r] / di + cfg.norm_eps)
              * (1.0 + p["norm"].locals[r].float())).to(y.dtype)
        outs.append(torch.einsum("bse,ed->bsd", yn, p["out_proj"].locals[r]))
    new_cache = cache
    if cache is None:
        new_cache = {"conv": states, "ssm": ssm_states} if return_state \
            else None
    return ctx.all_reduce(outs), new_cache


def block_apply(p, cfg: ModelConfig, x, cache=None,
                return_state: bool = False, ctx: Optional[Ctx] = None):
    h = apply_norm(p["ln"], x, cfg, ctx)
    out, new_cache = mixer_apply(p["mixer"], cfg, h, cache, return_state,
                                 ctx)
    return add(x, out), new_cache


# ----------------------------------------------------------------- model

def forward(params, cfg: ModelConfig, tokens, return_cache: bool = False,
            ctx: Optional[Ctx] = None):
    """Teacher-forcing forward. tokens: (B, S) -> (logits, aux[, cache]).
    With ``ctx``, over the slice: the cache's entries ``Sharded`` in the
    layout of :func:`cache_specs`' logical axes, the logits whole on the
    slice's first device."""
    b, s = tokens.shape
    x = embed_apply(params["embed"], cfg, tokens, ctx)
    cache = None
    if return_cache:
        # filled layer by layer: no list of per-layer states to stack; the
        # conv windows in the activations' dtype
        specs = cache_specs(cfg, b, s)
        specs["conv"] = specs["conv"]._replace(
            dtype=(x if ctx is None else x[0]).dtype)
        cache = dict(shd.empty(specs, ctx, tokens.device), pos=s)
    for i, layer in enumerate(shd.unstack(params["layers"])):
        if return_cache:
            x, st = block_apply(layer, cfg, x, return_state=True, ctx=ctx)
            shd.write_layer(cache["conv"], i, st["conv"])
            shd.write_layer(cache["ssm"], i, st["ssm"])
        else:
            x, _ = remat(cfg, block_apply, layer, cfg, x, None, False, ctx)
    x = apply_norm(params["ln_f"], x, cfg, ctx)
    logits = unembed_apply(params["embed"], cfg, x, ctx)
    aux = per_row(ctx, lambda: torch.zeros((), dtype=torch.float32,
                                           device=tokens.device))
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


def decode_step(params, cfg: ModelConfig, cache, tokens,
                ctx: Optional[Ctx] = None):
    """One decode step. tokens: (B, 1); cache conv/ssm updated in place
    (with ``ctx``, each device's blocks). Returns (logits, cache with
    pos + 1)."""
    x = embed_apply(params["embed"], cfg, tokens, ctx)
    for i, layer in enumerate(shd.unstack(params["layers"])):
        x, _ = block_apply(layer, cfg, x,
                           cache={"conv": shd.layer_view(cache["conv"], i),
                                  "ssm": shd.layer_view(cache["ssm"], i)},
                           ctx=ctx)
    x = apply_norm(params["ln_f"], x, cfg, ctx)
    logits = unembed_apply(params["embed"], cfg, x, ctx)
    return logits, {"conv": cache["conv"], "ssm": cache["ssm"],
                    "pos": int(cache["pos"]) + 1}
