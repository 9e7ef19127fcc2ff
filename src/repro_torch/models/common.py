"""Parameter-spec machinery shared by the model families.

Parameters are declared as :class:`ParamSpec` trees (nested dicts: shape +
logical axes + init), from which ``init_params`` materialises tensors from
an explicit ``torch.Generator`` and ``abstract_params`` makes ``meta``
tensors (shape and dtype, no storage: the dry run's inputs). ``canonical_flat`` gives the flat
``{key: leaf}`` view whose '/'-joined keys are the same as the JAX
package's (``repro.models.common.canonical_flat``): the StateManager and
the weight converter key on them.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

Axes = Tuple[Optional[str], ...]


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Axes                 # logical axis name per dim (None = unsharded)
    init: str = "normal"       # "normal" | "zeros" | "ones" | "embed" |
                               # "ssm_a" | "dt_bias"
    dtype: torch.dtype = torch.bfloat16
    scale: float = 1.0         # fan-in style scale multiplier for "normal"


def spec(shape, axes, init="normal", dtype=torch.bfloat16, scale=1.0) -> ParamSpec:
    assert len(shape) == len(axes), (shape, axes)
    return ParamSpec(tuple(int(s) for s in shape), tuple(axes), init, dtype, scale)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree, is_leaf: Callable = is_spec):
    """Map ``fn`` over the leaves of a nested-dict tree."""
    if isinstance(tree, dict) and not is_leaf(tree):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return fn(tree)


def stack_specs(tree, num: int):
    """Prepend a ``layers`` dimension to every spec in the tree."""
    return tree_map(lambda s: ParamSpec((num,) + s.shape, ("layers",) + s.axes,
                                        s.init, s.dtype, s.scale), tree)


def logical_axes(specs):
    """The logical-axes tree of a spec tree (``models/sharding.py``)."""
    return tree_map(lambda s: s.axes, specs)


def abstract_params(specs):
    """Each spec as a ``meta`` tensor of its shape and dtype."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


# each leaf is drawn in slices along its leading axis of at most this many
# elements (at least one row), straight into the leaf; a leaf within it is
# drawn as one slice
INIT_SLICE_ELEMS = 1 << 28


def _init_one(gen: torch.Generator, s: ParamSpec, device) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    if s.init == "ssm_a":
        # A_log init: log of uniform [1, 16) as in mamba2
        u = torch.rand(s.shape, generator=gen, dtype=torch.float32,
                       device=device) * 15.0 + 1.0
        return torch.log(u).to(s.dtype)
    if s.init == "dt_bias":
        # inverse-softplus of dt log-uniform in [1e-3, 1e-1]
        u = torch.rand(s.shape, generator=gen, dtype=torch.float32,
                       device=device)
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
        return (dt + torch.log(-torch.expm1(-dt))).to(s.dtype)
    # fan-in scaled normal; embeddings use unit scale
    fan_in = s.shape[0] if s.init == "embed" else math.prod(s.shape[:-1]) or 1
    std = s.scale / math.sqrt(fan_in) if s.init != "embed" else s.scale
    # drawn in slices: whole, Qwen3-30B-A3B's expert stack (9.66 G elements)
    # would be a 38.7 GB f32 transient on the card
    out = torch.empty(s.shape, dtype=s.dtype, device=device)
    rows = max(1, INIT_SLICE_ELEMS // math.prod(s.shape[1:]))
    for part in out.split(rows):
        x = torch.randn(part.shape, generator=gen, dtype=torch.float32,
                        device=device)
        part.copy_(x.mul_(std))
    return out


def unstack(tree):
    """The per-layer trees of a stacked tree (leading ``num_layers`` axis),
    as views: one ``unbind`` per leaf, whose backward stacks the layers'
    gradients in one op (``leaf[i]`` per layer would give each layer's
    gradient as a zero-filled full-size tensor, summed over the layers)."""
    parts = {k: torch.unbind(v) for k, v in canonical_flat(tree).items()}
    n = len(next(iter(parts.values())))
    return [canonical_unflatten(tree, {k: p[i] for k, p in parts.items()})
            for i in range(n)]


def init_params(gen: torch.Generator, specs, device=None):
    """Materialise a spec tree, drawing leaves in canonical-key order from
    ``gen`` (which must live on ``device``)."""
    flat = canonical_flat(specs)
    return canonical_unflatten(
        specs, {k: _init_one(gen, s, device) for k, s in flat.items()})


# ---------------------------------------------------------------- canonical keys

def canonical_flat(tree, is_leaf: Callable = is_spec,
                   prefix: str = "") -> Dict[str, Any]:
    """Flatten a nested-dict tree into {canonical_key: leaf}, keys sorted
    at every level as jax.tree_util flattens dicts."""
    if isinstance(tree, dict) and not is_leaf(tree):
        flat: Dict[str, Any] = {}
        for k in sorted(tree):
            flat.update(canonical_flat(tree[k], is_leaf, f"{prefix}{k}/"))
        return flat
    return {prefix[:-1]: tree}


def canonical_unflatten(template, flat: Dict[str, Any],
                        is_leaf: Callable = is_spec, prefix: str = ""):
    """Inverse of canonical_flat, keyed by the template tree's structure."""
    if isinstance(template, dict) and not is_leaf(template):
        return {k: canonical_unflatten(v, flat, is_leaf, f"{prefix}{k}/")
                for k, v in template.items()}
    return flat[prefix[:-1]]


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in canonical_flat(specs).values())

