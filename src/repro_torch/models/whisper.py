"""Whisper-large-v3 backbone in PyTorch: an encoder-decoder transformer.

The conv/mel frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings (B, encoder_seq, d_model), passed as the
batch's ``frames``. Positions are sinusoidal on both sides, layer norms
have a bias, the MLP is the plain biased one, and there is no RoPE.

Parameters keep the JAX package's tree and canonical keys (``enc_layers``,
``enc_ln_f``, ``layers`` with ``ln1/self_attn/ln2/cross_attn/ln3/mlp``,
``ln_f``), stacked on a leading layer axis. The encoder's self-attention
and the decoder's cross-attention prefill are non-causal K1 launches (the
encoder at S = T = encoder_seq, the cross-attention at S = prompt, T =
encoder_seq); the decoder's self-attention is K1 causal in the prefill and
K2 in each decode step, and the cross-attention of a decode step is K2
over all encoder_seq precomputed keys (``pos = encoder_seq - 1``).

The cache is ``{"k", "v": (L, B, T, K, D), "cross_k", "cross_v": (L, B,
encoder_seq, K, D), "pos": int}``: ``pos`` stays a host int, the
self-attention cache is written in place, and the cross K/V are computed
once by the prefill and only read afterwards.

With a ``ctx`` (``layers.Ctx``: a slice of several devices) every
function runs tensor-parallel, as the reference's GSPMD under the same
specs: the frames, the positions and the residual streams are on every
device, K1 and K2 run at each device's local heads (the encoder, the
cross prefill and the cross decode too), the biased MLP is column- then
row-parallel, and the caches, cross K/V included, are ``Sharded`` in the
layout of :func:`cache_specs`' logical axes. ``ctx=None`` is the
one-device path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import sharding as shd
from repro_torch.models.common import spec, stack_specs
from repro_torch.models.layers import (
    Ctx,
    add,
    apply_norm,
    attn_apply,
    attn_param_specs,
    cross_decode,
    embed_apply,
    embed_param_specs,
    mlp_apply,
    mlp_param_specs,
    norm_param_specs,
    on_slice,
    per_row,
    remat,
    sinusoidal_positions,
    unembed_apply,
)

# ------------------------------------------------------------------ params


def enc_layer_param_specs(cfg: ModelConfig):
    return {
        "ln1": norm_param_specs(cfg),
        "attn": attn_param_specs(cfg),
        "ln2": norm_param_specs(cfg),
        "mlp": mlp_param_specs(cfg, cfg.d_ff),
    }


def dec_layer_param_specs(cfg: ModelConfig):
    return {
        "ln1": norm_param_specs(cfg),
        "self_attn": attn_param_specs(cfg),
        "ln2": norm_param_specs(cfg),
        "cross_attn": attn_param_specs(cfg),
        "ln3": norm_param_specs(cfg),
        "mlp": mlp_param_specs(cfg, cfg.d_ff),
    }


def param_specs(cfg: ModelConfig):
    return {
        "embed": embed_param_specs(cfg),
        "enc_layers": stack_specs(enc_layer_param_specs(cfg),
                                  cfg.encoder_layers),
        "enc_ln_f": norm_param_specs(cfg),
        "layers": stack_specs(dec_layer_param_specs(cfg), cfg.num_layers),
        "ln_f": norm_param_specs(cfg),
    }


def _positions(b: int, s: int, device, ctx: Optional[Ctx] = None):
    return per_row(ctx, lambda: torch.arange(
        s, device=device)[None, :].expand(b, s))


def _add_positions(x, positions, cfg: ModelConfig):
    """x plus the f32 sinusoid cast to x's dtype, as the reference adds
    it; of a per-device list, on every device."""
    if isinstance(x, list):
        # every sequence's positions are alike: a data row's block takes
        # the first rows (of its row's own, :func:`layers.per_row`)
        rows = positions if isinstance(positions, list) else [positions]
        per = -(-len(x) // len(rows))
        return [_add_positions(xr, rows[r // per][:xr.shape[0]].to(
            xr.device), cfg) for r, xr in enumerate(x)]
    return x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)


# ----------------------------------------------------------------- encoder

def enc_layer_apply(p, cfg: ModelConfig, x, positions,
                    ctx: Optional[Ctx] = None):
    """One encoder layer: non-causal self-attention, then the MLP."""
    h = apply_norm(p["ln1"], x, cfg, ctx)
    a, _ = attn_apply(p["attn"], cfg, h, positions=positions, causal=False,
                      use_rope=False, ctx=ctx)
    x = add(x, a)
    return add(x, mlp_apply(p["mlp"], cfg, apply_norm(p["ln2"], x, cfg, ctx),
                            ctx))


def encode(params, cfg: ModelConfig, frames, ctx: Optional[Ctx] = None):
    """frames: (B, T_enc, d_model) stubbed frame embeddings -> (B, T_enc,
    d_model), per device with ``ctx``. Each layer runs under ``remat``."""
    b, t, _ = frames.shape
    positions = _positions(b, t, frames.device, ctx)
    x = _add_positions(on_slice(ctx, frames), positions, cfg)
    for layer in shd.unstack(params["enc_layers"]):
        x = remat(cfg, enc_layer_apply, layer, cfg, x, positions, ctx)
    return apply_norm(params["enc_ln_f"], x, cfg, ctx)


# ----------------------------------------------------------------- decoder

def dec_layer_apply(p, cfg: ModelConfig, x, enc_out, positions,
                    ctx: Optional[Ctx] = None, cache=None, cache_pos=None,
                    cross_kv=None):
    """One decoder layer: causal self-attention (written into ``cache`` at
    ``cache_pos`` when one is given), cross-attention over ``enc_out`` (the
    prefill) or the precomputed ``cross_kv`` (a decode step), then the
    MLP. Returns (x, self k/v or the cache, cross k/v)."""
    h = apply_norm(p["ln1"], x, cfg, ctx)
    a, kv = attn_apply(p["self_attn"], cfg, h, positions=positions,
                       causal=True, cache=cache, cache_pos=cache_pos,
                       use_rope=False, ctx=ctx)
    x = add(x, a)
    h = apply_norm(p["ln2"], x, cfg, ctx)
    if cross_kv is not None:
        c = cross_decode(p["cross_attn"], cfg, h, cross_kv["k"],
                         cross_kv["v"], ctx)
        ckv = cross_kv
    else:
        c, ckv = attn_apply(p["cross_attn"], cfg, h, positions=positions,
                            kv_x=enc_out, causal=False, use_rope=False,
                            ctx=ctx)
    x = add(x, c)
    return add(x, mlp_apply(p["mlp"], cfg, apply_norm(p["ln3"], x, cfg, ctx),
                            ctx)), kv, ckv


def forward(params, cfg: ModelConfig, tokens, frames,
            return_cache: bool = False, ctx: Optional[Ctx] = None):
    """Teacher-forcing forward. tokens: (B, S); frames: (B, T_enc,
    d_model) -> (logits, aux 0[, cache]). Each encoder and decoder layer
    runs under ``remat``, which runs it directly where no gradient is
    wanted (the prefill that builds a cache). With ``ctx``,
    tensor-parallel over the slice; the logits come back whole on its
    first device."""
    b, s = tokens.shape
    enc_out = encode(params, cfg, frames, ctx)
    positions = _positions(b, s, tokens.device, ctx)
    x = _add_positions(embed_apply(params["embed"], cfg, tokens, ctx),
                       positions, cfg)
    kvs = []
    for layer in shd.unstack(params["layers"]):
        x, kv, ckv = remat(cfg, dec_layer_apply, layer, cfg, x, enc_out,
                           positions, ctx)
        if return_cache:
            kvs.append((kv, ckv))
    x = apply_norm(params["ln_f"], x, cfg, ctx)
    logits = unembed_apply(params["embed"], cfg, x, ctx)
    aux = per_row(ctx, lambda: torch.zeros((), dtype=torch.float32,
                                           device=tokens.device))
    if return_cache:
        specs = cache_specs(cfg, b, s)
        cache = {name: shd.stack([kv[i][part] for kv in kvs], ctx,
                                 specs[name])
                 for name, i, part in (("k", 0, "k"), ("v", 0, "v"),
                                       ("cross_k", 1, "k"),
                                       ("cross_v", 1, "v"))}
        return logits, aux, dict(cache, pos=s)
    return logits, aux


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    k, hd, l = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers
    kv = spec((l, batch, max_len, k, hd),
              ("layers", "cache_batch", "cache_seq", "kv_heads", "cache_hd"),
              "zeros")
    ckv = spec((l, batch, cfg.encoder_seq, k, hd),
               ("layers", "cache_batch", None, "kv_heads", "cache_hd"),
               "zeros")
    return {"k": kv, "v": kv, "cross_k": ckv, "cross_v": ckv}


def decode_step(params, cfg: ModelConfig, cache, tokens,
                ctx: Optional[Ctx] = None):
    """One decode step. tokens: (B, 1); the self-attention cache is
    written in place at ``cache["pos"]``, the cross K/V only read. Returns
    (logits, cache with pos + 1). With ``ctx``, tensor-parallel over the
    slice, the cache's locals written in place."""
    b = tokens.shape[0]
    pos = int(cache["pos"])
    positions = per_row(ctx, lambda: torch.full(
        (b, 1), pos, dtype=torch.int32, device=tokens.device))
    x = _add_positions(embed_apply(params["embed"], cfg, tokens, ctx),
                       positions, cfg)
    for i, layer in enumerate(shd.unstack(params["layers"])):
        x, _, _ = dec_layer_apply(
            layer, cfg, x, None, positions, ctx,
            cache={n: shd.layer_view(cache[n], i) for n in ("k", "v")},
            cache_pos=pos,
            cross_kv={n: shd.layer_view(cache[f"cross_{n}"], i)
                      for n in ("k", "v")})
    x = apply_norm(params["ln_f"], x, cfg, ctx)
    logits = unembed_apply(params["embed"], cfg, x, ctx)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "cross_k": cache["cross_k"],
                    "cross_v": cache["cross_v"], "pos": pos + 1}
