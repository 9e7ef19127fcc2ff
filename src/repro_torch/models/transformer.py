"""Dense and MoE decoder-only transformer LM (qwen2, qwen3, gemma2,
deepseek-coder, granite-moe, arctic and the paper's Qwen3 MoE shapes).

Full-sequence forward (prefill, optionally building the KV cache) and
single-token decode against it. Parameters keep the JAX package's stacked
layout: every ``layers/...`` tensor has a leading ``num_layers`` axis, and
layer ``i`` reads the ``i``-th view of its ``unbind``. The cache is
``{"k", "v": (L, B, T, K, D), "pos": int}``; ``pos`` stays a host int so
the decode loop never reads a device scalar back.

Layers run in groups of ``local_global_period`` (one layer but for
gemma2, whose groups are a local layer with a sliding window, then a
global one), as the reference scans them; the training forward
rematerialises each group under ``cfg.remat`` (``layers.remat``).

With a ``ctx`` (``layers.Ctx``: a slice of several devices) the dense
and MoE families (gemma2's post-norms on the all-reduced outputs) run
tensor-parallel: the parameters are ``Sharded``
leaves, the residual stream is one tensor per device, and the cache's k
and v are ``Sharded`` in the layout of :func:`cache_specs`' logical axes
under the rules (split over KV heads, else over head_dim, ``cache_hd``).
The MoE runs over the experts (``models/moe.py``); its loss is the first
device's. The logits come back whole on the slice's first device.
``ctx=None`` is the one-device path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models import sharding as shd
from repro_torch.models.common import spec, stack_specs, unstack
from repro_torch.models.layers import (
    Ctx,
    add,
    apply_norm,
    attn_apply,
    attn_param_specs,
    embed_apply,
    embed_param_specs,
    mlp_apply,
    mlp_param_specs,
    norm_param_specs,
    per_row,
    remat,
    unembed_apply,
)


# ------------------------------------------------------------------ params

def layer_param_specs(cfg: ModelConfig):
    p = {
        "ln1": norm_param_specs(cfg),
        "attn": attn_param_specs(cfg),
        "ln2": norm_param_specs(cfg),
    }
    if cfg.num_experts:
        p["moe"] = moe_lib.moe_param_specs(cfg)
    if not cfg.num_experts or cfg.dense_residual:
        p["mlp"] = mlp_param_specs(cfg, cfg.d_ff)
    if cfg.post_norms:
        p["ln1_post"] = norm_param_specs(cfg)
        p["ln2_post"] = norm_param_specs(cfg)
    return p


def param_specs(cfg: ModelConfig):
    return {
        "embed": embed_param_specs(cfg),
        "layers": stack_specs(layer_param_specs(cfg), cfg.num_layers),
        "ln_f": norm_param_specs(cfg),
    }


def _group_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, period): groups of ``period`` layers, each sub-layer with
    its static window."""
    period = cfg.local_global_period or 1
    assert cfg.num_layers % period == 0, (cfg.name, cfg.num_layers, period)
    return cfg.num_layers // period, period


def _sub_window(cfg: ModelConfig, j: int, period: int) -> int:
    """Static sliding window for sub-layer j of a group (gemma2: local
    first, global last)."""
    if cfg.sliding_window and period > 1 and j < period - 1:
        return cfg.sliding_window
    if cfg.sliding_window and period == 1:
        return cfg.sliding_window
    return 0


# ----------------------------------------------------------------- forward

def _ffn(p, cfg: ModelConfig, x, ctx: Optional[Ctx] = None):
    """The MLP, or the MoE (plus arctic's parallel dense MLP). Returns
    (out, aux). With ``ctx``, over the slice (per-device lists)."""
    if cfg.num_experts:
        out, aux = moe_lib.moe_apply(p["moe"], cfg, x, ctx)
        if cfg.dense_residual:
            out = add(out, mlp_apply(p["mlp"], cfg, x, ctx))
        return out, aux
    return mlp_apply(p["mlp"], cfg, x, ctx), None


def _layer_apply_tp(p, cfg: ModelConfig, xs, *, positions, window, cache,
                    cache_pos, ctx: Ctx):
    h = apply_norm(p["ln1"], xs, cfg, ctx)
    a, kv = attn_apply(p["attn"], cfg, h, positions=positions, causal=True,
                       window=window, cache=cache, cache_pos=cache_pos,
                       ctx=ctx)
    if cfg.post_norms:
        a = apply_norm(p["ln1_post"], a, cfg, ctx)
    xs = add(xs, a)
    m, aux = _ffn(p, cfg, apply_norm(p["ln2"], xs, cfg, ctx), ctx)
    if cfg.post_norms:
        m = apply_norm(p["ln2_post"], m, cfg, ctx)
    return add(xs, m), aux, kv


def layer_apply(p, cfg: ModelConfig, x, *, positions, window: int = 0,
                cache=None, cache_pos=None, ctx: Optional[Ctx] = None):
    """One decoder layer. Returns (x, aux, kv); aux is None without
    experts. With ``ctx``, ``x`` and the cache's k and v are per-device
    lists."""
    if ctx is not None:
        return _layer_apply_tp(p, cfg, x, positions=positions, window=window,
                               cache=cache, cache_pos=cache_pos, ctx=ctx)
    h = apply_norm(p["ln1"], x, cfg)
    a, kv = attn_apply(p["attn"], cfg, h, positions=positions, causal=True,
                       window=window, cache=cache, cache_pos=cache_pos)
    if cfg.post_norms:
        a = apply_norm(p["ln1_post"], a, cfg)
    x = x + a
    h = apply_norm(p["ln2"], x, cfg)
    m, aux = _ffn(p, cfg, h)
    if cfg.post_norms:
        m = apply_norm(p["ln2_post"], m, cfg)
    return x + m, aux, kv


def group_apply(group, cfg: ModelConfig, x, positions, with_kv: bool,
                ctx: Optional[Ctx] = None):
    """One group of layers (``group``: their parameter trees). Returns
    (x, the layers' MoE losses stacked or None[, their fresh k/v])."""
    period = len(group)
    auxs, kvs = [], []
    for j, layer in enumerate(group):
        x, aux, kv = layer_apply(layer, cfg, x, positions=positions,
                                 window=_sub_window(cfg, j, period), ctx=ctx)
        if aux is not None:
            auxs.append(aux)
        if with_kv:
            kvs.append(kv)
    aux = _stack_aux(auxs) if auxs else None
    return (x, aux, kvs) if with_kv else (x, aux)


def _stack_aux(auxs, op=torch.stack):
    """The layers' MoE losses joined by ``op``: of tensors, or over data
    rows of per-row lists, row by row."""
    if isinstance(auxs[0], list):
        return [op([a[i] for a in auxs]) for i in range(len(auxs[0]))]
    return op(auxs)


def _forward_tp(params, cfg: ModelConfig, tokens, return_cache: bool,
                ctx: Ctx):
    b, s = tokens.shape
    xs = embed_apply(params["embed"], cfg, tokens, ctx)
    positions = per_row(ctx, lambda: torch.arange(
        s, device=tokens.device)[None, :].expand(b, s))
    _, period = _group_layout(cfg)
    layers = shd.unstack(params["layers"])
    cache, auxs = None, []
    if return_cache:
        # filled layer by layer, each device's blocks in the layout of the
        # cache's logical axes
        specs = {k: sp._replace(dtype=xs[0].dtype)
                 for k, sp in cache_specs(cfg, b, s).items()}
        cache = dict(shd.empty(specs, ctx), pos=s)
    for g in range(0, cfg.num_layers, period):
        group = layers[g:g + period]
        if return_cache:
            xs, aux, kvs = group_apply(group, cfg, xs, positions, True, ctx)
            for j, kv in enumerate(kvs):
                shd.write_layer(cache["k"], g + j, kv["k"])
                shd.write_layer(cache["v"], g + j, kv["v"])
        else:
            xs, aux = remat(cfg, group_apply, group, cfg, xs, positions,
                            False, ctx)
        if aux is not None:
            auxs.append(aux)
    logits = unembed_apply(params["embed"], cfg,
                           apply_norm(params["ln_f"], xs, cfg, ctx), ctx)
    # the MoE loss, on the first device, once for the slice (over data
    # rows, once a row)
    if auxs:
        aux = _stack_aux(auxs, torch.cat)
        aux = [a.mean() for a in aux] if isinstance(aux, list) \
            else aux.mean()
    else:
        aux = per_row(ctx, lambda: torch.zeros((), dtype=torch.float32,
                                               device=tokens.device))
    if return_cache:
        return logits, aux, cache
    return logits, aux


def forward(params, cfg: ModelConfig, tokens, return_cache: bool = False,
            ctx: Optional[Ctx] = None):
    """Teacher-forcing forward. tokens: (B, S) -> (logits, aux[, cache]);
    aux is the MoE loss's mean over the layers (0 without experts). Without
    a cache each group of layers runs under ``remat``; the prefill that
    builds a cache never needs a gradient and runs directly. With ``ctx``,
    tensor-parallel over the slice."""
    if ctx is not None:
        return _forward_tp(params, cfg, tokens, return_cache, ctx)
    b, s = tokens.shape
    x = embed_apply(params["embed"], cfg, tokens)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    _, period = _group_layout(cfg)
    layers = unstack(params["layers"])
    ks, vs, auxs = [], [], []
    for g in range(0, cfg.num_layers, period):
        group = layers[g:g + period]
        if return_cache:
            x, aux, kvs = group_apply(group, cfg, x, positions, True)
            ks += [kv["k"] for kv in kvs]
            vs += [kv["v"] for kv in kvs]
        else:
            x, aux = remat(cfg, group_apply, group, cfg, x, positions, False)
        if aux is not None:
            auxs.append(aux)
    x = apply_norm(params["ln_f"], x, cfg)
    logits = unembed_apply(params["embed"], cfg, x)
    aux = torch.cat(auxs).mean() if auxs else \
        torch.zeros((), dtype=torch.float32, device=tokens.device)
    if return_cache:
        cache = {"k": torch.stack(ks), "v": torch.stack(vs), "pos": s}
        return logits, aux, cache
    return logits, aux


# ------------------------------------------------------------------ decode

def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    k, hd, l = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers
    kv = spec((l, batch, max_len, k, hd),
              ("layers", "cache_batch", "cache_seq", "kv_heads", "cache_hd"),
              "zeros")
    return {"k": kv, "v": kv}


def _decode_step_tp(params, cfg: ModelConfig, cache, tokens, ctx: Ctx):
    b = tokens.shape[0]
    pos = int(cache["pos"])
    xs = embed_apply(params["embed"], cfg, tokens, ctx)
    positions = per_row(ctx, lambda: torch.full(
        (b, 1), pos, dtype=torch.int32, device=tokens.device))
    _, period = _group_layout(cfg)
    for i, layer in enumerate(shd.unstack(params["layers"])):
        xs, _, _ = layer_apply(
            layer, cfg, xs, positions=positions,
            window=_sub_window(cfg, i % period, period),
            cache={"k": shd.layer_view(cache["k"], i),
                   "v": shd.layer_view(cache["v"], i)},
            cache_pos=pos, ctx=ctx)
    logits = unembed_apply(params["embed"], cfg,
                           apply_norm(params["ln_f"], xs, cfg, ctx), ctx)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def decode_step(params, cfg: ModelConfig, cache, tokens,
                ctx: Optional[Ctx] = None):
    """One decode step. tokens: (B, 1); cache k/v: (L, B, T, K, D) written
    in place at ``cache["pos"]``. Returns (logits, cache with pos + 1).
    With ``ctx``, tensor-parallel over the slice, the cache's locals
    written in place."""
    if ctx is not None:
        return _decode_step_tp(params, cfg, cache, tokens, ctx)
    b = tokens.shape[0]
    pos = int(cache["pos"])
    x = embed_apply(params["embed"], cfg, tokens)
    positions = torch.full((b, 1), pos, dtype=torch.int32,
                           device=tokens.device)
    _, period = _group_layout(cfg)
    for i, layer in enumerate(unstack(params["layers"])):
        # the MoE loss of a decode step is discarded, as the reference's
        x, _, _ = layer_apply(layer, cfg, x, positions=positions,
                              window=_sub_window(cfg, i % period, period),
                              cache={"k": cache["k"][i], "v": cache["v"][i]},
                              cache_pos=pos)
    x = apply_norm(params["ln_f"], x, cfg)
    logits = unembed_apply(params["embed"], cfg, x)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
