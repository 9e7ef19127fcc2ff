"""Logical-axis -> mesh-axis sharding rules (MaxText-style), with best-effort
divisibility resolution: the port of ``repro.models.sharding``'s
device-free half.

Two rule sets ship by default:

- ``RULES_TP``      — paper-faithful ZeRO-2 analogue: tensor-parallel params
  over the ``model`` axis, replicated over ``data``; optimizer moments are
  additionally sharded over ``data`` (see repro_torch.train.optimizer).
- ``RULES_FSDP_TP`` — beyond-paper default for very large models: adds
  FSDP-style sharding of the embed dim over ``data``.

``resolve(axes, mesh, rules)`` maps a logical-axis tuple to a
:class:`PartitionSpec`, dropping any assignment whose dim is not divisible
by the mesh axes and any mesh axis already used by an earlier dim.

Everything here is logic over shapes: a mesh is anything with a ``shape``
dict and ``axis_names`` (:class:`MeshShape` stands in for the production
meshes of 256 and 512 devices), and a :class:`PartitionSpec` is a tuple of
mesh-axis entries, equal as a tuple to the reference's. Placing tensors by
these specs (the reference's ``tree_shardings`` and ``constrain``) needs a
multi-device runtime, which is not ported (ROADMAP.md, Queue 1: item 5,
sharding).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.models import common

MeshAxes = Union[None, str, Tuple[str, ...]]
Rules = Tuple[Tuple[str, MeshAxes], ...]


class PartitionSpec(tuple):
    """A mesh-axis entry per dim (None, an axis name, or a tuple of names),
    trailing unsharded dims left out: ``PartitionSpec("data", None,
    "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class MeshShape:
    """A shape-only mesh: axis sizes by name, no devices."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


RULES_TP: Rules = (
    ("batch", ("pod", "data")),
    ("cache_batch", ("pod", "data")),
    # fallback: KV-cache head_dim takes the model axis only when kv_heads
    # could not (GQA archs with kv_heads < mesh model size). head_dim is
    # chosen over the seq dim because the decode cache write
    # (dynamic-update-slice at `pos`) would force SPMD to rematerialise a
    # seq-sharded buffer every step.
    ("cache_hd", "model"),
    ("cache_seq", None),
    # prefill OUTPUT caches: seq-sharded over model (cheap slicing of the
    # per-layer K/V stack; no decode-time DUS to worry about)
    ("cache_seq_out", "model"),
    # fallback: MoE expert-capacity / per-expert mlp dims take the model
    # axis only when the expert count could not (granite: 40 experts on a
    # 16-way axis)
    ("expert_cap", None),
    ("expert_mlp", None),
    ("seq_res", None),              # residual-stream seq (SP rules: model)
    ("vocab", "model"),
    ("embed", None),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("qkv_merged", "model"),
    ("mlp", "model"),
    ("experts", "model"),
    ("ssm_inner", "model"),
    ("ssm_heads", "model"),
    ("conv_dim", "model"),
    ("layers", None),
    ("seq", None),
    ("state", None),
    ("head_dim", None),
    ("groups", None),
)

RULES_FSDP_TP: Rules = (("embed", "data"),) + tuple(
    (k, v) for k, v in RULES_TP if k != "embed"
)

# Beyond-paper: Megatron-style sequence parallelism — the residual stream is
# sharded over the model axis between blocks.
RULES_FSDP_TP_SP: Rules = (("seq_res", "model"),) + tuple(
    (k, v) for k, v in RULES_FSDP_TP if k != "seq_res"
)

# Context-parallel overrides for the long-context decode cells: the KV cache's
# sequence dim is sharded over `data` (batch=1 cannot use it).
RULES_LONG_CONTEXT: Rules = (
    ("cache_seq", "data"),
    ("cache_batch", "pod"),
    ("batch", "pod"),
) + tuple(
    (k, v)
    for k, v in RULES_TP
    if k not in ("cache_seq", "cache_batch", "batch")
)


def named_rules(name: str) -> Rules:
    return {
        "tp": RULES_TP,
        "fsdp_tp": RULES_FSDP_TP,
        "fsdp_tp_sp": RULES_FSDP_TP_SP,
        "long": RULES_LONG_CONTEXT,
    }[name]


def _mesh_axes_tuple(v: MeshAxes) -> Tuple[str, ...]:
    if v is None:
        return ()
    if isinstance(v, str):
        return (v,)
    return tuple(v)


# Axes only assigned in a second pass, after the primary axes had their
# chance — e.g. a decode cache's head_dim takes the model axis only when
# kv_heads could not (GQA archs whose kv count doesn't divide the mesh).
FALLBACK_AXES = {"cache_hd"}


def resolve(axes: Sequence[Optional[str]], mesh, rules: Rules,
            shape: Optional[Sequence[int]] = None) -> PartitionSpec:
    """Logical axes -> PartitionSpec, best-effort divisible, two-pass
    (primary axes then fallback axes), no mesh axis used twice."""
    rule_map = dict(rules)
    used: set = set()
    out: list = [None] * len(axes)

    def try_assign(i, ax):
        assigned: Tuple[str, ...] = ()
        if ax is not None and ax in rule_map:
            cand = tuple(
                m for m in _mesh_axes_tuple(rule_map[ax])
                if m in mesh.axis_names and m not in used
            )
            if cand:
                total = math.prod(mesh.shape[m] for m in cand)
                if shape is None or (total and shape[i] % total == 0):
                    assigned = cand
        used.update(assigned)
        if len(assigned) == 1:
            out[i] = assigned[0]
        elif assigned:
            out[i] = assigned

    for i, ax in enumerate(axes):
        if ax not in FALLBACK_AXES:
            try_assign(i, ax)
    for i, ax in enumerate(axes):
        if ax in FALLBACK_AXES:
            try_assign(i, ax)
    # trim trailing Nones for tidier specs
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def tree_partition_specs(axes_tree, mesh, rules: Rules, shapes_tree=None):
    """Map a logical-axes tree (nested dicts, tuples as leaves) to
    PartitionSpecs; ``shapes_tree`` (the same tree of tensors or specs)
    gives each leaf's shape for the divisibility check."""
    if shapes_tree is None:
        return common.tree_map(lambda a: resolve(a, mesh, rules), axes_tree)
    shapes = common.canonical_flat(shapes_tree)
    return common.canonical_unflatten(axes_tree, {
        k: resolve(a, mesh, rules, shape=shapes[k].shape)
        for k, a in common.canonical_flat(axes_tree).items()})
