"""Seeded weights of a dense decoder, in the reference's layout.

Every leaf is drawn on the device by its own ``torch.Generator``, seeded from
(seed, job, leaf name), in one call straight into the served dtype (bf16).
A leaf can so be drawn again alone, on the same device, to the same bits:
the reference does that after the program's state is gone, and the check of
a round trip through the state layer compares against it.

Layout (L layers stacked on the first axis; matrices as (in, out)):

    embed (V, d)            unembed (d, V) when the embedding is not tied
    wq (L, d, H*D)  wk, wv (L, d, K*D)  bq (L, H*D)  bk, bv (L, K*D)
    wo (L, H*D, d)  w_gate, w_up (L, d, F)  w_down (L, F, d)
    ln1, ln2 (L, d)  ln_f (d,)   RMS-norm gains stored as offsets from 1
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Tuple

import torch


def leaf_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every leaf's shape, from a configuration file's sizes."""
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    n, h, k = (cfg["num_hidden_layers"], cfg["num_attention_heads"],
               cfg["num_key_value_heads"])
    hd = cfg["head_dim"]
    shapes = {
        "embed": (v, d),
        "wq": (n, d, h * hd), "wk": (n, d, k * hd), "wv": (n, d, k * hd),
        "bq": (n, h * hd), "bk": (n, k * hd), "bv": (n, k * hd),
        "wo": (n, h * hd, d),
        "w_gate": (n, d, f), "w_up": (n, d, f), "w_down": (n, f, d),
        "ln1": (n, d), "ln2": (n, d), "ln_f": (d,),
    }
    if not cfg["attention_bias"]:
        for name in ("bq", "bk", "bv"):
            del shapes[name]
    if not cfg["tie_word_embeddings"]:
        shapes["unembed"] = (d, v)
    return shapes


def leaf_seed(seed: int, job: int, name: str) -> int:
    """A 63-bit generator seed for one leaf of one job's weights."""
    digest = hashlib.sha256(f"{seed}:{job}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def make_leaf(cfg: dict, seed: int, job: int, name: str,
              device) -> torch.Tensor:
    """One leaf in bf16 on ``device``: norm offsets are 0, every other leaf
    a normal draw of std ``init_std``."""
    shape = leaf_shapes(cfg)[name]
    if name.startswith("ln"):
        return torch.zeros(shape, dtype=torch.bfloat16, device=device)
    gen = torch.Generator(device=device).manual_seed(
        leaf_seed(seed, job, name))
    out = torch.empty(shape, dtype=torch.bfloat16, device=device)
    return out.normal_(0.0, cfg["init_std"], generator=gen)


def make_weights(cfg: dict, seed: int, job: int, device,
                 names: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """The leaves ``names`` (all of them by default) of job ``job``."""
    names = list(names) or list(leaf_shapes(cfg))
    return {n: make_leaf(cfg, seed, job, n, device) for n in names}


def param_count(cfg: dict) -> int:
    total = 0
    for shape in leaf_shapes(cfg).values():
        count = 1
        for s in shape:
            count *= s
        total += count
    return total
