"""Autoregressive rollout with a KV cache: prefill + decode loop.

The ``generate`` service primitive. Sampling is temperature-based from an
explicit ``torch.Generator`` (on the logits' device), greedy when
``temperature <= 0``; behavior logprobs are returned for importance-sampled
objectives. The loop runs on the host with ``pos`` a host int, and nothing
in it reads a device value back, so the card runs ahead of Python.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.models.registry import Model


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    max_new_tokens: int = 32
    temperature: float = 1.0
    eos_id: int = 2


def _pad_cache(cache, extra: int):
    """Grow the cache's T axis (axis ndim-3 of (L, B, T, K, D)) by ``extra``
    zero slots."""
    out = {}
    for k, v in cache.items():
        if k in ("k", "v") and torch.is_tensor(v) and v.ndim >= 4:
            shape = list(v.shape)
            shape[v.ndim - 3] = extra
            out[k] = torch.cat([v, v.new_zeros(shape)], dim=v.ndim - 3)
        else:
            out[k] = v
    return out


def rollout(model: Model, params, prompt_tokens, gen: torch.Generator,
            cfg: RolloutConfig = RolloutConfig()
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Generate completions. prompt_tokens: (B, P) integer tensor.

    Returns (completions (B, N), logprobs (B, N), alive mask (B, N)).
    """
    logits, _, cache = model.forward(params, {"tokens": prompt_tokens},
                                     return_cache=True)
    logits = logits[:, -1]
    cache = _pad_cache(cache, cfg.max_new_tokens)

    def sample(logits):
        logits = logits.float()
        if cfg.temperature <= 0:
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
                                              {"tokens": tok[:, None]})
        alive = alive & (tok != cfg.eos_id)
        logits = new_logits[:, -1]
        toks.append(tok)
        logps.append(logp)
        alives.append(alive)
    return torch.stack(toks, 1), torch.stack(logps, 1), torch.stack(alives, 1)
