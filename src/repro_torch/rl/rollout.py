"""Autoregressive rollout with a KV cache: prefill + decode loop.

The ``generate`` service primitive. Sampling is temperature-based from an
explicit ``torch.Generator`` (on the logits' device), greedy when
``greedy`` is set or ``temperature <= 0``; behavior logprobs are returned
for importance-sampled objectives. The loop runs on the host with ``pos`` a host int, and nothing
in it reads a device value back, so the card runs ahead of Python.

Over a slice of several devices (``ctx``) the model runs tensor-parallel
and its logits come back whole on the slice's first device, where the
sampling reads them (the reference samples the logits GSPMD lays out
over the slice).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import sharding as shd
from repro_torch.models.layers import Ctx
from repro_torch.models.registry import Model


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    max_new_tokens: int = 32
    temperature: float = 1.0
    greedy: bool = False
    eos_id: int = 2


def _pad_cache(cache, extra: int):
    """Grow the self-attention caches' T axis (axis ndim-3 of
    (..., B, T, K, D): the dense family's and whisper's ``k``/``v``, the
    hybrid's ``attn_k``/``attn_v``) by ``extra`` zero slots; whisper's
    ``cross_k``/``cross_v`` keep the encoder's length. A ``Sharded`` cache
    (over a slice) grows each local tensor."""

    def pad(v):
        shape = list(v.shape)
        shape[v.ndim - 3] = extra
        return torch.cat([v, v.new_zeros(shape)], dim=v.ndim - 3)

    out = {}
    for k, v in cache.items():
        if k in ("k", "v", "attn_k", "attn_v") and (
                torch.is_tensor(v) or isinstance(v, shd.Sharded)) \
                and v.dim() >= 4:
            out[k] = shd.leafwise(pad, v)
        else:
            out[k] = v
    return out


def rollout(model: Model, params, prompt_tokens, gen: torch.Generator,
            cfg: RolloutConfig = RolloutConfig(),
            extra_inputs: Optional[Dict[str, Any]] = None,
            ctx: Optional[Ctx] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Generate completions. prompt_tokens: (B, P) integer tensor (on the
    slice's first device); ``extra_inputs`` join the prefill's batch only
    (whisper's ``frames``).

    Returns (completions (B, N), logprobs (B, N), alive mask (B, N)).
    """
    batch = {"tokens": prompt_tokens, **(extra_inputs or {})}
    logits, _, cache = model.forward(params, batch, return_cache=True,
                                     ctx=ctx)
    logits = logits[:, -1]
    cache = _pad_cache(cache, cfg.max_new_tokens)

    def sample(logits):
        logits = logits.float()
        if cfg.greedy or cfg.temperature <= 0:
            tok = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits / cfg.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
        logp = torch.log_softmax(logits, dim=-1)
        return tok, torch.gather(logp, 1, tok[:, None])[:, 0]

    b = prompt_tokens.shape[0]
    alive = torch.ones((b,), dtype=torch.bool, device=prompt_tokens.device)
    eos = torch.full_like(alive, cfg.eos_id, dtype=prompt_tokens.dtype)
    toks, logps, alives = [], [], []
    for _ in range(cfg.max_new_tokens):
        tok, logp = sample(logits)
        tok = torch.where(alive, tok.to(prompt_tokens.dtype), eos)
        new_logits, cache = model.decode_step(params, cache,
                                              {"tokens": tok[:, None]},
                                              ctx=ctx)
        alive = alive & (tok != cfg.eos_id)
        logits = new_logits[:, -1]
        toks.append(tok)
        logps.append(logp)
        alives.append(alive)
    return torch.stack(toks, 1), torch.stack(logps, 1), torch.stack(alives, 1)
