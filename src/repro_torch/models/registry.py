"""Unified model API: the :class:`Model` facade for the ``dense``, ``moe``,
``ssm`` (mamba2), ``hybrid`` (zamba2), ``audio`` (whisper) and ``vlm``
(llama-3.2-vision) families: every family of the JAX package.

    model.forward(params, batch, return_cache=False)
    model.decode_step(params, cache, batch)
    model.param_specs() / init_params(generator, device) / param_count()
    model.active_param_count()
    model.cache_specs(batch, max_len)

``batch`` is a dict with ``tokens``, ``frames`` for audio and ``vision``
for vlm, as in ``repro.models.registry``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import (common, hybrid, mamba2, transformer, vision,
                                whisper)

_FAMILY_MODULES = {"dense": transformer, "moe": transformer, "ssm": mamba2,
                   "hybrid": hybrid, "audio": whisper, "vlm": vision}


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.mod = _FAMILY_MODULES[cfg.family]

    # ------------------------------------------------------------- params
    def param_specs(self):
        return self.mod.param_specs(self.cfg)

    def init_params(self, gen: torch.Generator, device=None):
        return common.init_params(gen, self.param_specs(), device)

    def param_count(self) -> int:
        return common.param_count(self.param_specs())

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts active)."""
        cfg = self.cfg
        total = self.param_count()
        if not cfg.num_experts:
            return total
        expert = sum(
            math.prod(s.shape) for key, s in
            common.canonical_flat(self.param_specs()).items()
            if "/moe/" in f"/{key}/" and any(
                w in key for w in ("wi_gate", "wi_up", "wo")))
        return total - expert + expert * cfg.experts_per_token \
            // cfg.num_experts

    # ------------------------------------------------------------ compute
    def _extras(self, batch: Dict[str, Any]):
        """The family's inputs beside the tokens: audio's frames, vlm's
        patch embeddings."""
        if self.cfg.family == "audio":
            return (batch["frames"],)
        if self.cfg.family == "vlm":
            return (batch["vision"],)
        return ()

    def forward(self, params, batch: Dict[str, Any],
                return_cache: bool = False):
        return self.mod.forward(params, self.cfg, batch["tokens"],
                                *self._extras(batch),
                                return_cache=return_cache)

    def decode_step(self, params, cache, batch: Dict[str, Any]):
        return self.mod.decode_step(params, self.cfg, cache, batch["tokens"])

    def cache_specs(self, batch: int, max_len: int):
        return self.mod.cache_specs(self.cfg, batch, max_len)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
