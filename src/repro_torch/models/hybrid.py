"""zamba2-style hybrid: a Mamba2 backbone with ONE shared attention block
whose weights are re-applied every ``attn_period`` blocks (11 applications
for the 81-block zamba2-7b).

Mirrors ``repro.models.hybrid``. Layout for L total blocks, period q:

    n_attn   = L // q                      (shared-attention applications)
    n_mamba  = L - n_attn                  (Mamba2 blocks)
    grouped  = n_attn groups of (q - 1) Mamba2 blocks, each followed by the
               shared block; then n_mamba - n_attn (q - 1) trailing blocks.

The shared block keeps a separate KV cache per application (the weights
are shared, the activations are not). The decode cache is

    {"attn_k", "attn_v": (n_attn, B, T, K, D),
     "conv_g": (n_attn, q - 1, B, conv_dim, K - 1),
     "ssm_g": (n_attn, q - 1, B, H, P, N) f32,
     "conv_t", "ssm_t": the same per trailing block, "pos": host int}.

The prefill fills it layer by layer (no per-layer lists to stack), and
``decode_step`` writes each Mamba2 block's conv window and SSM state and
each application's KV slot in place, as ``mamba2.py`` and ``attn_apply``
do. On the card the Mamba2 prefill runs K3, the shared block's prefill K1
and its decode K2 (through ``models/layers.py`` and ``models/mamba2.py``).
The training forward rematerialises each group (its Mamba2 blocks and
that application of the shared block) and each trailing block under
``cfg.remat`` (``layers.remat``), as the reference checkpoints its scans.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import mamba2 as mb
from repro_torch.models.common import spec, stack_specs, unstack
from repro_torch.models.layers import (
    apply_norm,
    attn_apply,
    attn_param_specs,
    embed_apply,
    embed_param_specs,
    mlp_apply,
    mlp_param_specs,
    norm_param_specs,
    remat,
    unembed_apply,
)


def _layout(cfg: ModelConfig):
    """(shared-attention applications, Mamba2 blocks a group, trailing
    Mamba2 blocks)."""
    q = cfg.attn_period
    n_attn = cfg.num_layers // q
    n_mamba = cfg.num_layers - n_attn
    per_group = q - 1
    return n_attn, per_group, n_mamba - n_attn * per_group


def shared_block_param_specs(cfg: ModelConfig):
    return {
        "ln1": norm_param_specs(cfg),
        "attn": attn_param_specs(cfg),
        "ln2": norm_param_specs(cfg),
        "mlp": mlp_param_specs(cfg, cfg.d_ff),
    }


def param_specs(cfg: ModelConfig):
    n_attn, per_group, trailing = _layout(cfg)
    p = {
        "embed": embed_param_specs(cfg),
        "mamba_grouped": stack_specs(
            stack_specs(mb.layer_param_specs(cfg), per_group), n_attn),
        "shared_attn": shared_block_param_specs(cfg),
        "ln_f": norm_param_specs(cfg),
    }
    if trailing:
        p["mamba_tail"] = stack_specs(mb.layer_param_specs(cfg), trailing)
    return p


def _shared_attn_apply(p, cfg: ModelConfig, x, positions, cache=None,
                       cache_pos=None):
    h = apply_norm(p["ln1"], x, cfg)
    a, kv = attn_apply(p["attn"], cfg, h, positions=positions, causal=True,
                       window=0, cache=cache, cache_pos=cache_pos)
    x = x + a
    h = apply_norm(p["ln2"], x, cfg)
    return x + mlp_apply(p["mlp"], cfg, h), kv


def group_apply(group, shared, cfg: ModelConfig, x, positions):
    """One group without a cache: its Mamba2 blocks (``group``, stacked),
    then the shared block."""
    for layer in unstack(group):
        x, _ = mb.block_apply(layer, cfg, x)
    return _shared_attn_apply(shared, cfg, x, positions)[0]


def forward(params, cfg: ModelConfig, tokens, return_cache: bool = False):
    """Teacher-forcing forward. tokens: (B, S) -> (logits, aux[, cache]).
    Without a cache each group and trailing block runs under ``remat``;
    the prefill that builds a cache runs directly."""
    b, s = tokens.shape
    x = embed_apply(params["embed"], cfg, tokens)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    shared = params["shared_attn"]
    cache = None
    if return_cache:
        cache = {k: torch.empty(sp.shape, dtype=sp.dtype, device=x.device)
                 for k, sp in cache_specs(cfg, b, s).items()}
        cache["pos"] = s

    groups = unstack(params["mamba_grouped"])
    tail = unstack(params["mamba_tail"]) if "mamba_tail" in params else []
    if not return_cache:
        for group in groups:
            x = remat(cfg, group_apply, group, shared, cfg, x, positions)
        for layer in tail:
            x, _ = remat(cfg, mb.block_apply, layer, cfg, x)
    else:
        for g, group in enumerate(groups):
            for i, layer in enumerate(unstack(group)):
                x, st = mb.block_apply(layer, cfg, x, return_state=True)
                cache["conv_g"][g, i] = st["conv"]
                cache["ssm_g"][g, i] = st["ssm"]
            x, kv = _shared_attn_apply(shared, cfg, x, positions)
            cache["attn_k"][g] = kv["k"]
            cache["attn_v"][g] = kv["v"]
        for i, layer in enumerate(tail):
            x, st = mb.block_apply(layer, cfg, x, return_state=True)
            cache["conv_t"][i] = st["conv"]
            cache["ssm_t"][i] = st["ssm"]
    x = apply_norm(params["ln_f"], x, cfg)
    logits = unembed_apply(params["embed"], cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if return_cache:
        return logits, aux, cache
    return logits, aux


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """Decode cache: a KV cache per application, the conv window and SSM
    state per Mamba2 block."""
    n_attn, per_group, trailing = _layout(cfg)
    k, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    conv = (batch, mb.conv_dim(cfg), cfg.ssm_conv - 1)
    ssm = (batch, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state)
    kv = spec((n_attn, batch, max_len, k, hd),
              ("layers", "cache_batch", "cache_seq", "kv_heads", "cache_hd"),
              "zeros")
    c = {
        "attn_k": kv,
        "attn_v": kv,
        "conv_g": spec((n_attn, per_group) + conv,
                       ("layers", None, "cache_batch", "conv_dim", None),
                       "zeros"),
        "ssm_g": spec((n_attn, per_group) + ssm,
                      ("layers", None, "cache_batch", "ssm_heads", None, None),
                      "zeros", dtype=torch.float32),
    }
    if trailing:
        c["conv_t"] = spec((trailing,) + conv,
                           ("layers", "cache_batch", "conv_dim", None),
                           "zeros")
        c["ssm_t"] = spec((trailing,) + ssm,
                          ("layers", "cache_batch", "ssm_heads", None, None),
                          "zeros", dtype=torch.float32)
    return c


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """One decode step. tokens: (B, 1); every conv window, SSM state and
    KV slot ``pos`` updated in place. Returns (logits, cache with
    pos + 1)."""
    b = tokens.shape[0]
    pos = int(cache["pos"])
    x = embed_apply(params["embed"], cfg, tokens)
    positions = torch.full((b, 1), pos, dtype=torch.int32,
                           device=tokens.device)
    shared = params["shared_attn"]
    for g, group in enumerate(unstack(params["mamba_grouped"])):
        for i, layer in enumerate(unstack(group)):
            x, _ = mb.block_apply(layer, cfg, x,
                                  cache={"conv": cache["conv_g"][g, i],
                                         "ssm": cache["ssm_g"][g, i]})
        x, _ = _shared_attn_apply(shared, cfg, x, positions,
                                  cache={"k": cache["attn_k"][g],
                                         "v": cache["attn_v"][g]},
                                  cache_pos=pos)
    if "mamba_tail" in params:
        for i, layer in enumerate(unstack(params["mamba_tail"])):
            x, _ = mb.block_apply(layer, cfg, x,
                                  cache={"conv": cache["conv_t"][i],
                                         "ssm": cache["ssm_t"][i]})
    x = apply_norm(params["ln_f"], x, cfg)
    logits = unembed_apply(params["embed"], cfg, x)
    return logits, dict(cache, pos=pos + 1)
