"""The dense family's weights handed to the port, and read back from it.

The port keeps a nested-dict tree whose leaves hold the same numbers as the
reference's leaves, some of them reshaped: the attention projections split
their head axis in two. ``PORT_KEYS`` maps the port's canonical key (its
'/'-joined path) to the reference's leaf name.
"""
from __future__ import annotations

from typing import Dict

import torch

PORT_KEYS = {
    "embed/embedding": "embed",
    "embed/unembed": "unembed",
    "layers/attn/wq": "wq", "layers/attn/wk": "wk", "layers/attn/wv": "wv",
    "layers/attn/bq": "bq", "layers/attn/bk": "bk", "layers/attn/bv": "bv",
    "layers/attn/wo": "wo",
    "layers/ln1/scale": "ln1", "layers/ln2/scale": "ln2",
    "layers/mlp/wi_gate": "w_gate", "layers/mlp/wi_up": "w_up",
    "layers/mlp/wo": "w_down",
    "ln_f/scale": "ln_f",
}


def port_shape(cfg: dict, name: str, t: torch.Tensor) -> torch.Tensor:
    """A reference leaf viewed in the port's shape."""
    h, k, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                cfg["head_dim"])
    n, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    if name == "wq":
        return t.view(n, d, h, hd)
    if name in ("wk", "wv"):
        return t.view(n, d, k, hd)
    if name == "bq":
        return t.view(n, h, hd)
    if name in ("bk", "bv"):
        return t.view(n, k, hd)
    if name == "wo":
        return t.view(n, h, hd, d)
    return t


def to_port(cfg: dict, weights: Dict[str, torch.Tensor]) -> dict:
    """The port's parameter tree over the reference leaves (views)."""
    tree: dict = {}
    for key, name in PORT_KEYS.items():
        if name not in weights:
            continue
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = port_shape(cfg, name, weights[name])
    return tree


def flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{canonical key: leaf} of a nested-dict tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def by_reference_name(tree) -> Dict[str, torch.Tensor]:
    """A port tree's leaves keyed by the reference's leaf names."""
    return {PORT_KEYS[k]: v for k, v in flat(tree).items()}
