"""Unified model API: the :class:`Model` facade for the ``dense``, ``ssm``
(mamba2) and ``hybrid`` (zamba2) families.

    model.forward(params, batch, return_cache=False)
    model.decode_step(params, cache, batch)
    model.param_specs() / init_params(generator, device) / param_count()
    model.cache_specs(batch, max_len)

``batch`` is a dict with ``tokens``, as in ``repro.models.registry``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import common, hybrid, mamba2, transformer

_FAMILY_MODULES = {"dense": transformer, "ssm": mamba2, "hybrid": hybrid}
_NOT_PORTED = {"moe": "MoE", "audio": "whisper and vision",
               "vlm": "whisper and vision"}


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in _FAMILY_MODULES:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet "
                f"(ROADMAP.md, Queue 1: {_NOT_PORTED[cfg.family]})")
        self.cfg = cfg
        self.mod = _FAMILY_MODULES[cfg.family]

    # ------------------------------------------------------------- params
    def param_specs(self):
        return self.mod.param_specs(self.cfg)

    def init_params(self, gen: torch.Generator, device=None):
        return common.init_params(gen, self.param_specs(), device)

    def param_count(self) -> int:
        return common.param_count(self.param_specs())

    # ------------------------------------------------------------ compute
    def forward(self, params, batch: Dict[str, Any],
                return_cache: bool = False):
        return self.mod.forward(params, self.cfg, batch["tokens"],
                                return_cache=return_cache)

    def decode_step(self, params, cache, batch: Dict[str, Any]):
        return self.mod.decode_step(params, self.cfg, cache, batch["tokens"])

    def cache_specs(self, batch: int, max_len: int):
        return self.mod.cache_specs(self.cfg, batch, max_len)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
