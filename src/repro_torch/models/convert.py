"""Carry parameters between the JAX package and the port, by canonical key.

The JAX package's parameters, flattened with its ``canonical_flat`` and
moved to numpy, become the port's parameter tree under the same keys, and
back. Stacked ``layers/...`` arrays keep their leading ``(L, ...)`` axis:
the port's layers read views of the stacked tensors too. bf16 crosses
losslessly as a 16-bit integer view (numpy has no native bf16; the JAX
side's arrays carry ml_dtypes' ``bfloat16``).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import common
from repro_torch.models.registry import build_model


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.name == "bfloat16"


def tensor_from_numpy(arr: np.ndarray, device=None) -> torch.Tensor:
    """numpy (incl. ml_dtypes bf16) -> torch, bit-exact."""
    if _is_bf16(arr):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy, bit-exact; bf16 comes back as ml_dtypes' bfloat16."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_reference(flat: Mapping[str, np.ndarray], cfg: ModelConfig,
                          device=None):
    """The JAX package's ``canonical_flat`` params (numpy) -> the port's
    param tree. Every key and shape must match the port's specs."""
    specs = build_model(cfg).param_specs()
    want = common.canonical_flat(specs)
    if set(want) != set(flat):
        raise KeyError(f"canonical keys differ: missing "
                       f"{sorted(set(want) - set(flat))}, extra "
                       f"{sorted(set(flat) - set(want))}")
    out: Dict[str, torch.Tensor] = {}
    for key, s in want.items():
        arr = flat[key]
        if tuple(arr.shape) != s.shape:
            raise ValueError(f"{key}: shape {arr.shape} != spec {s.shape}")
        out[key] = tensor_from_numpy(arr, device)
    return common.canonical_unflatten(specs, out)


def params_to_reference(params) -> Dict[str, np.ndarray]:
    """The port's param tree -> ``canonical_flat`` numpy arrays for the JAX
    package (``repro.models.common.canonical_unflatten`` rebuilds its tree)."""
    flat = common.canonical_flat(params)
    return {k: tensor_to_numpy(v) for k, v in flat.items()}
