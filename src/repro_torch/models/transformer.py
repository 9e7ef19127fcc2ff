"""Dense decoder-only transformer LM (qwen2, qwen3, deepseek-coder shapes).

Full-sequence forward (prefill, optionally building the KV cache) and
single-token decode against it. Parameters keep the JAX package's stacked
layout: every ``layers/...`` tensor has a leading ``num_layers`` axis, and
layer ``i`` reads views ``[i]`` of it. The cache is
``{"k", "v": (L, B, T, K, D), "pos": int}``; ``pos`` stays a host int so
the decode loop never reads a device scalar back.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models.common import layer_view, spec, stack_specs
from repro_torch.models.layers import (
    apply_norm,
    attn_apply,
    attn_param_specs,
    embed_apply,
    embed_param_specs,
    mlp_apply,
    mlp_param_specs,
    norm_param_specs,
    unembed_apply,
)

# config fields this dense port does not run yet -> the ROADMAP item that
# will port them
_NOT_PORTED = {
    "num_experts": "MoE",
    "sliding_window": "gemma2 decode",
    "local_global_period": "gemma2 decode",
    "attn_logit_softcap": "gemma2 decode",
    "post_norms": "gemma2 decode",
    "final_logit_softcap": "gemma2 decode",
}


def check_supported(cfg: ModelConfig) -> None:
    for field, item in _NOT_PORTED.items():
        if getattr(cfg, field):
            raise NotImplementedError(
                f"{cfg.name}: {field} is not ported yet "
                f"(ROADMAP.md, Queue 1: {item})")
    if cfg.act != "silu":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.act} MLP is not ported yet "
            "(ROADMAP.md, Queue 1: gemma2 decode)")
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.norm} is not ported yet "
            "(ROADMAP.md, Queue 1: whisper and vision)")


# ------------------------------------------------------------------ params

def layer_param_specs(cfg: ModelConfig):
    return {
        "ln1": norm_param_specs(cfg),
        "attn": attn_param_specs(cfg),
        "ln2": norm_param_specs(cfg),
        "mlp": mlp_param_specs(cfg, cfg.d_ff),
    }


def param_specs(cfg: ModelConfig):
    check_supported(cfg)
    return {
        "embed": embed_param_specs(cfg),
        "layers": stack_specs(layer_param_specs(cfg), cfg.num_layers),
        "ln_f": norm_param_specs(cfg),
    }


# ----------------------------------------------------------------- forward

def layer_apply(p, cfg: ModelConfig, x, *, positions, cache=None,
                cache_pos=None):
    """One decoder layer. Returns (x, kv)."""
    h = apply_norm(p["ln1"], x, cfg)
    a, kv = attn_apply(p["attn"], cfg, h, positions=positions, causal=True,
                       cache=cache, cache_pos=cache_pos)
    x = x + a
    h = apply_norm(p["ln2"], x, cfg)
    return x + mlp_apply(p["mlp"], cfg, h), kv


def forward(params, cfg: ModelConfig, tokens, return_cache: bool = False):
    """Teacher-forcing forward. tokens: (B, S) -> (logits, aux[, cache])."""
    check_supported(cfg)
    b, s = tokens.shape
    x = embed_apply(params["embed"], cfg, tokens)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, kv = layer_apply(layer_view(params["layers"], i), cfg, x,
                            positions=positions)
        if return_cache:
            ks.append(kv["k"])
            vs.append(kv["v"])
    x = apply_norm(params["ln_f"], x, cfg)
    logits = unembed_apply(params["embed"], cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
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


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """One decode step. tokens: (B, 1); cache k/v: (L, B, T, K, D) written
    in place at ``cache["pos"]``. Returns (logits, cache with pos + 1)."""
    check_supported(cfg)
    b = tokens.shape[0]
    pos = int(cache["pos"])
    x = embed_apply(params["embed"], cfg, tokens)
    positions = torch.full((b, 1), pos, dtype=torch.int32,
                           device=tokens.device)
    for i in range(cfg.num_layers):
        x, _ = layer_apply(layer_view(params["layers"], i), cfg, x,
                           positions=positions,
                           cache={"k": cache["k"][i], "v": cache["v"][i]},
                           cache_pos=pos)
    x = apply_norm(params["ln_f"], x, cfg)
    logits = unembed_apply(params["embed"], cfg, x)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
