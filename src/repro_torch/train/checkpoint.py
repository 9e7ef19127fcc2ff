"""Checkpointing: canonical-key shard save and restore (the port of
``repro.train.checkpoint``, in its on-disk format byte for byte).

Checkpoints are materialised from the canonicalised state view (paper
§4.5.3: "checkpoint creation is treated as materialisation from managed
state"): every tensor is stored under its canonical key, independent of any
process-local layout. A checkpoint written by either package restores in
the other.

Layout:
  <dir>/<name>/metadata.json           step, keys, shapes, dtypes
  <dir>/<name>/shard_<i>.npz           canonical_key (``/`` -> ``__``) ->
                                       ndarray, bf16 as a uint16 view
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import common

_SHARD_BYTES = 512 * 1024 * 1024


def to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor as numpy on the host and its dtype's name; bf16 (which
    numpy lacks) as its 16-bit pattern in a uint16 array."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """Inverse of :func:`to_numpy`: a CPU tensor that owns its memory."""
    if dtype == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(path: str, tree, step: int = 0,
         extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """Save a tree of tensors. Returns the checkpoint directory."""
    os.makedirs(path, exist_ok=True)
    flat = common.canonical_flat(tree)
    meta: Dict[str, Any] = {"step": int(step), "tensors": {},
                            **(extra_meta or {})}
    shards: list = [{}]
    sizes = [0]
    for key, leaf in flat.items():
        arr, dtype = to_numpy(leaf)
        meta["tensors"][key] = {
            "shape": list(arr.shape), "dtype": dtype,
            "shard": len(shards) - 1,
        }
        if sizes[-1] + arr.nbytes > _SHARD_BYTES and shards[-1]:
            shards.append({})
            sizes.append(0)
            meta["tensors"][key]["shard"] = len(shards) - 1
        shards[-1][key.replace("/", "__")] = arr
        sizes[-1] += arr.nbytes
    for i, shard in enumerate(shards):
        np.savez(os.path.join(path, f"shard_{i}.npz"), **shard)
    tmp = os.path.join(path, "metadata.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(path, "metadata.json"))  # atomic commit
    return path


def load_flat(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """{canonical key: CPU tensor} and the metadata."""
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    out: Dict[str, torch.Tensor] = {}
    by_shard: Dict[int, list] = {}
    for key, info in meta["tensors"].items():
        by_shard.setdefault(info["shard"], []).append((key, info))
    for shard_idx, entries in by_shard.items():
        with np.load(os.path.join(path, f"shard_{shard_idx}.npz")) as z:
            for key, info in entries:
                out[key] = from_numpy(z[key.replace("/", "__")],
                                      info["dtype"])
    return out, meta


def restore(path: str, template_tree, device=None):
    """Restore into the template's structure, on ``device`` (the CPU by
    default). Returns (tree, metadata)."""
    flat, meta = load_flat(path)
    tree = common.canonical_unflatten(
        template_tree, {k: v.to(device) for k, v in flat.items()})
    return tree, meta


def latest(dirpath: str) -> Optional[str]:
    """The newest complete checkpoint under dirpath (step_* naming)."""
    if not os.path.isdir(dirpath):
        return None
    cands = []
    for name in os.listdir(dirpath):
        full = os.path.join(dirpath, name)
        if os.path.exists(os.path.join(full, "metadata.json")):
            cands.append((os.path.getmtime(full), full))
    return max(cands)[1] if cands else None
