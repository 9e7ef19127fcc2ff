"""llama-3.2-vision backbone in PyTorch: a dense decoder with a tanh-gated
cross-attention image layer every ``cross_attn_period`` layers.

The vision tower is a stub, as in the JAX package: the model takes patch
embeddings already projected to d_model (B, vision_seq, d_model), passed
as the batch's ``vision``. The layers run in groups of ``period - 1``
self-attention layers (``transformer.layer_apply``, no window), then one
cross layer whose attention and MLP outputs are scaled by ``tanh`` of an
f32 gate (zero at init, so an image-free init leaves the text path as it
is), the tanh cast to x's dtype before the product, as the reference.

Parameters keep the JAX package's tree and canonical keys: ``self_layers``
stacked twice, ``(n_groups, per_group, ...)``, ``cross_layers`` once. The
self-attention is K1 causal in the prefill and K2 in each decode step;
the cross-attention prefill is K1 non-causal over all vision_seq keys,
neither q nor k rotated, and a decode step's cross-attention is K2 over
the precomputed cross K/V (``pos = vision_seq - 1``), q projected alone,
unrotated, at head_dim^-1/2 with no cap.

The cache is ``{"k", "v": (G, per_group, B, T, K, D), "cross_k",
"cross_v": (G, B, vision_seq, K, D), "pos": int}``: ``pos`` stays a host
int, the self-attention cache is written in place, and the cross K/V are
computed once by the prefill and only read afterwards.

With a ``ctx`` (``layers.Ctx``: a slice of several devices) every
function runs tensor-parallel, as the reference's GSPMD under the same
specs: the self layers through the dense family's tensor-parallel layers,
the patch embeddings and the residual streams on every device, K1 and K2
at each device's local heads (the cross prefill and the cross decode
too), the gates (replicated scalars) applied on every device after the
all-reduced attention and MLP outputs, and the caches ``Sharded`` in the
layout of :func:`cache_specs`' logical axes. ``ctx=None`` is the
one-device path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.models.common import spec, stack_specs
from repro_torch.models.layers import (
    Ctx,
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
    unembed_apply,
)


def _layout(cfg: ModelConfig):
    """(n_groups, per_group): each group is ``per_group`` self layers,
    then one cross layer."""
    q = cfg.cross_attn_period
    return cfg.num_layers // q, q - 1


# ------------------------------------------------------------------ params

def cross_layer_param_specs(cfg: ModelConfig):
    return {
        "ln1": norm_param_specs(cfg),
        "attn": attn_param_specs(cfg),
        "gate_attn": spec((), (), "zeros", dtype=torch.float32),
        "ln2": norm_param_specs(cfg),
        "mlp": mlp_param_specs(cfg, cfg.d_ff),
        "gate_mlp": spec((), (), "zeros", dtype=torch.float32),
    }


def param_specs(cfg: ModelConfig):
    n_groups, per_group = _layout(cfg)
    return {
        "embed": embed_param_specs(cfg),
        "self_layers": stack_specs(
            stack_specs(tf.layer_param_specs(cfg), per_group), n_groups),
        "cross_layers": stack_specs(cross_layer_param_specs(cfg), n_groups),
        "ln_f": norm_param_specs(cfg),
    }


# ----------------------------------------------------------------- forward

def _gated(gate, x, out):
    """x + tanh(gate) * out, the f32 tanh cast to x's dtype first; of
    per-device lists, on every device by its copy of the gate."""
    if isinstance(x, list):
        return [_gated(g, xr, o)
                for g, xr, o in zip(shd.local_tensors(gate), x, out)]
    return x + torch.tanh(gate).to(x.dtype) * out


def cross_layer_apply(p, cfg: ModelConfig, x, vision, positions,
                      cross_kv=None, ctx: Optional[Ctx] = None):
    """The gated cross layer: attention over ``vision`` (the prefill, K1
    non-causal, no RoPE on either side) or over the precomputed
    ``cross_kv`` (a decode step), then the MLP, each output scaled by its
    gate. Returns (x, cross k/v)."""
    h = apply_norm(p["ln1"], x, cfg, ctx)
    if cross_kv is not None:
        a = cross_decode(p["attn"], cfg, h, cross_kv["k"], cross_kv["v"],
                         ctx)
        kv = cross_kv
    else:
        a, kv = attn_apply(p["attn"], cfg, h, positions=positions,
                           kv_x=vision, causal=False, use_rope=False, ctx=ctx)
    x = _gated(p["gate_attn"], x, a)
    m = mlp_apply(p["mlp"], cfg, apply_norm(p["ln2"], x, cfg, ctx), ctx)
    return _gated(p["gate_mlp"], x, m), kv


def group_apply(p_group, p_cross, cfg: ModelConfig, x, vision, positions,
                with_kv: bool, ctx: Optional[Ctx] = None):
    """One group: its self layers (``p_group``, stacked), then the cross
    layer. Returns (x[, self k and v stacked (per_group, B, S, K, D),
    the cross k/v]); with ``ctx``, per-device lists."""
    ks, vs = [], []
    for layer in shd.unstack(p_group):
        x, _, kv = tf.layer_apply(layer, cfg, x, positions=positions,
                                  window=0, ctx=ctx)
        ks.append(kv["k"])
        vs.append(kv["v"])
    x, ckv = cross_layer_apply(p_cross, cfg, x, vision, positions, ctx=ctx)
    if with_kv:
        return x, shd.stack(ks, ctx), shd.stack(vs, ctx), ckv
    return x


def forward(params, cfg: ModelConfig, tokens, vision,
            return_cache: bool = False, ctx: Optional[Ctx] = None):
    """Teacher-forcing forward. tokens: (B, S); vision: (B, T_vis,
    d_model) stubbed patch embeddings -> (logits, aux 0[, cache]). Without
    a cache each group runs under ``remat``, as the reference's
    ``jax.checkpoint(group_body)``; the prefill that builds a cache never
    needs a gradient and runs directly. With ``ctx``, tensor-parallel over
    the slice (the patch embeddings on every device); the logits come
    back whole on its first device."""
    b, s = tokens.shape
    x = embed_apply(params["embed"], cfg, tokens, ctx)
    vision = on_slice(ctx, vision)
    positions = per_row(ctx, lambda: torch.arange(
        s, device=tokens.device)[None, :].expand(b, s))
    ks, vs, cks, cvs = [], [], [], []
    for p_group, p_cross in zip(shd.unstack(params["self_layers"]),
                                shd.unstack(params["cross_layers"])):
        if return_cache:
            x, k, v, ckv = group_apply(p_group, p_cross, cfg, x, vision,
                                       positions, True, ctx)
            ks.append(k)
            vs.append(v)
            cks.append(ckv["k"])
            cvs.append(ckv["v"])
        else:
            x = remat(cfg, group_apply, p_group, p_cross, cfg, x, vision,
                      positions, False, ctx)
    x = apply_norm(params["ln_f"], x, cfg, ctx)
    logits = unembed_apply(params["embed"], cfg, x, ctx)
    aux = per_row(ctx, lambda: torch.zeros((), dtype=torch.float32,
                                           device=tokens.device))
    if return_cache:
        specs = cache_specs(cfg, b, s)
        cache = {name: shd.stack(vals, ctx, specs[name])
                 for name, vals in (("k", ks), ("v", vs), ("cross_k", cks),
                                    ("cross_v", cvs))}
        return logits, aux, dict(cache, pos=s)
    return logits, aux


# ------------------------------------------------------------------ decode

def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    n_groups, per_group = _layout(cfg)
    k, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    kv = spec((n_groups, per_group, batch, max_len, k, hd),
              ("layers", None, "cache_batch", "cache_seq", "kv_heads",
               "cache_hd"), "zeros")
    ckv = spec((n_groups, batch, cfg.vision_seq, k, hd),
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
    x = embed_apply(params["embed"], cfg, tokens, ctx)
    for g, (p_group, p_cross) in enumerate(zip(
            shd.unstack(params["self_layers"]),
            shd.unstack(params["cross_layers"]))):
        for j, layer in enumerate(shd.unstack(p_group)):
            x, _, _ = tf.layer_apply(
                layer, cfg, x, positions=positions, window=0,
                cache={n: shd.layer_view(cache[n], (g, j))
                       for n in ("k", "v")},
                cache_pos=pos, ctx=ctx)
        x, _ = cross_layer_apply(
            p_cross, cfg, x, None, positions,
            cross_kv={n: shd.layer_view(cache[f"cross_{n}"], g)
                      for n in ("k", "v")}, ctx=ctx)
    x = apply_norm(params["ln_f"], x, cfg, ctx)
    logits = unembed_apply(params["embed"], cfg, x, ctx)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "cross_k": cache["cross_k"],
                    "cross_v": cache["cross_v"], "pos": pos + 1}
