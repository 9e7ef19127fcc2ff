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

The rest places tensors by these specs on a mesh (``launch/mesh.py``: a
slice's (1, n), or a mesh with ``data`` and ``pod`` rows), with one
process driving every device as JAX's single controller does:
:class:`NamedSharding` (a mesh and a spec), :class:`Sharded` (a global
tensor as one local tensor per device), :func:`shard` /
:func:`device_put` / :func:`gather`, the explicit collectives
:func:`all_reduce`, :func:`all_gather` and :func:`reduce_scatter` over
the members of a group (:func:`axis_groups`: the devices that differ only
along the named axes), each a copy between devices, ``Tensor.to``, and a
sum in one fixed device order, so a replicated result is the same bits
on every device; autograd runs through the first two (an all-reduce's
gradient is an all-reduce, an all-gather's a reduce-scatter), and each
records its bytes with the cost counter (``kernels/ops.collective``).
Then :func:`constrain`, :func:`tree_shardings`, and the helpers that
build a per-layer cache on one device or a mesh (:func:`empty`,
:func:`write_layer`, :func:`layer_view`). A layout over one device is a
plain tensor on it: the one-device path is the port's path before
sharding.

A shape-only mesh is anything with a ``shape`` dict and ``axis_names``
(:class:`MeshShape`), and a :class:`PartitionSpec` is a tuple of
mesh-axis entries, equal as a tuple to the reference's.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import common

MeshAxes = Union[None, str, Tuple[str, ...]]
Rules = Tuple[Tuple[str, MeshAxes], ...]


class PartitionSpec(tuple):
    """A mesh-axis entry per dim (None, an axis name, or a tuple of names),
    trailing unsharded dims left out: ``PartitionSpec("data", None,
    "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        # pickle rebuilds through ``__new__(*entries)`` (a spec crosses the
        # process plane's pipe inside a ``NamedSharding``)
        return tuple(self)

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


# ----------------------------------------------------------- not ported

# the queued parts of ROADMAP.md's Queue 1 item 5 (multi-device execution)
PARTS = {
    6: "mesh_bench.py",
}


def not_ported(what: str, part: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1: item 5, sharding, "
        f"part {part}: {PARTS[part]})")


def tp_unsupported(cfg) -> Optional[NotImplementedError]:
    """The error for a config whose family does not run over a slice of
    several devices: None for every config (the dense, MoE, ssm, hybrid,
    audio and vlm families and gemma2's post-norms all run there)."""
    return None


# ------------------------------------------------------------- placement

class NamedSharding:
    """A layout: a mesh (``launch/mesh.py``'s ``Mesh``) and a spec."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and \
            self.mesh == other.mesh and tuple(self.spec) == tuple(other.spec)

    def __hash__(self):
        return hash((self.mesh, tuple(self.spec)))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    @property
    def devices(self) -> List[torch.device]:
        return self.mesh.flat_devices()

    def parts(self, ndim: int) -> Tuple[int, ...]:
        """The number of blocks along each of ``ndim`` dims."""
        ents = list(self.spec) + [None] * (ndim - len(self.spec))
        return tuple(math.prod(self.mesh.shape[a]
                               for a in _mesh_axes_tuple(e)) for e in ents)

    def block(self, pos: int, ndim: int) -> Tuple[int, ...]:
        """The block index along each dim of the device at flat position
        ``pos``: the mixed-radix number of its coordinates on the dim's
        mesh axes, the first axis most significant (as JAX lays it out)."""
        coords = dict(zip(self.mesh.axis_names,
                          np.unravel_index(pos, self.mesh.devices.shape)))
        ents = list(self.spec) + [None] * (ndim - len(self.spec))
        out = []
        for e in ents:
            idx = 0
            for a in _mesh_axes_tuple(e):
                idx = idx * self.mesh.shape[a] + int(coords[a])
            out.append(idx)
        return tuple(out)

    def slices(self, pos: int, shape) -> Tuple[slice, ...]:
        """The index of device ``pos``'s block of a global ``shape``."""
        parts = self.parts(len(shape))
        for d, (n, p) in enumerate(zip(shape, parts)):
            if n % p:
                raise ValueError(f"{self.spec} splits dim {d} of "
                                 f"{tuple(shape)} into {p} parts")
        return tuple(slice(b * (n // p), (b + 1) * (n // p))
                     for b, n, p in zip(self.block(pos, len(shape)), shape,
                                        parts))

    def fits(self, shape) -> bool:
        """Whether the spec divides ``shape`` on this mesh."""
        if len(self.spec) > len(shape):
            return False
        for e in self.spec:
            if any(a not in self.mesh.shape for a in _mesh_axes_tuple(e)):
                return False
        return all(n % p == 0 for n, p in zip(shape, self.parts(len(shape))))


class Sharded:
    """A global tensor laid out on a mesh: one local tensor per device of
    the mesh (row-major), each on its device (or, offloaded, on the host;
    the sharding still names where it belongs). Replicas of a block are
    distinct tensors, so an in-place update of one never writes
    another."""

    __slots__ = ("locals", "sharding", "shape", "dtype")

    def __init__(self, locals_: Sequence[torch.Tensor],
                 sharding: NamedSharding):
        self.locals = list(locals_)
        self.sharding = sharding
        loc = self.locals[0]
        self.shape = torch.Size(
            n * p for n, p in zip(loc.shape, sharding.parts(loc.dim())))
        self.dtype = loc.dtype

    def __repr__(self):
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, "
                f"{self.sharding.spec!r}, {len(self.locals)} locals)")

    @property
    def device(self) -> torch.device:
        return self.locals[0].device

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return self.locals[0].element_size()

    @property
    def requires_grad(self) -> bool:
        return any(t.requires_grad for t in self.locals)

    def map(self, fn: Callable, *others: "Sharded") -> "Sharded":
        """``fn`` over the locals (and those of ``others``, position by
        position), in this layout."""
        return Sharded([fn(*ts) for ts in zip(
            self.locals, *(o.locals for o in others))], self.sharding)

    def first_of_blocks(self) -> List[int]:
        """The first position holding each block: the locals a sum over
        the global tensor reads once."""
        seen, out = set(), []
        for pos in range(len(self.locals)):
            b = self.sharding.block(pos, self.dim())
            if b not in seen:
                seen.add(b)
                out.append(pos)
        return out

    def copy_(self, src) -> "Sharded":
        """Write ``src`` (a global tensor, or a :class:`Sharded` of any
        layout) into the locals, in place."""
        if isinstance(src, Sharded) and src.sharding == self.sharding:
            for dst, s in zip(self.locals, src.locals):
                dst.copy_(s)
            return self
        if isinstance(src, Sharded):
            src = gather(src, self.locals[0].device)
        if tuple(src.shape) != tuple(self.shape):
            raise ValueError(f"copy_ of {tuple(src.shape)} into "
                             f"{tuple(self.shape)}")
        for pos, dst in enumerate(self.locals):
            dst.copy_(src[self.sharding.slices(pos, self.shape)])
        return self


def splits(leaf, dim: int, axis: str = "model") -> bool:
    """Whether a :class:`Sharded` leaf's ``dim`` is split over ``axis``."""
    ents = list(leaf.sharding.spec) + [None] * leaf.dim()
    return axis in _mesh_axes_tuple(ents[dim])


def empty(specs, ctx=None, device=None):
    """A tree of specs (``common.spec``) as uninitialised tensors: the
    caches a prefill fills layer by layer. Without ``ctx``, tensors on
    ``device``; over a slice (``ctx``: ``models/layers.Ctx``, its mesh and
    rules), :class:`Sharded` tensors, each in the layout its logical axes
    resolve to."""

    def one(sp):
        if ctx is None:
            return torch.empty(sp.shape, dtype=sp.dtype, device=device)
        sh = NamedSharding(ctx.mesh, resolve(sp.axes, ctx.mesh, ctx.rules,
                                             shape=sp.shape))
        local = [n // p for n, p in zip(sp.shape, sh.parts(len(sp.shape)))]
        return Sharded([torch.empty(local, dtype=sp.dtype, device=d)
                        for d in ctx.devices], sh)

    return common.tree_map(one, specs)


def write_layer(entry, index, value) -> None:
    """``entry[index] = value`` in place: of a tensor, or of a
    :class:`Sharded` cache entry's locals from per-device blocks."""
    if not isinstance(entry, Sharded):
        entry[index] = value
        return
    for loc, v in zip(entry.locals, value):
        loc[index] = v


def stack(blocks, ctx=None, sp=None):
    """Per-layer values stacked on a new leading axis: ``torch.stack`` of
    tensors; over a slice (``ctx``; each block a per-device list), each
    device's blocks stacked, as a list, or with ``sp`` (the stacked
    value's ``common.spec``) as a :class:`Sharded` in the layout its
    logical axes resolve to."""
    if ctx is None:
        return torch.stack(blocks)
    locs = [torch.stack([b[r] for b in blocks]) for r in range(len(blocks[0]))]
    if sp is None:
        return locs
    return Sharded(locs, NamedSharding(ctx.mesh, resolve(
        sp.axes, ctx.mesh, ctx.rules, shape=sp.shape)))


def layer_view(entry, index):
    """``entry[index]``: a view of a tensor, or per-device views of a
    :class:`Sharded` entry's locals."""
    if not isinstance(entry, Sharded):
        return entry[index]
    return [t[index] for t in entry.locals]


def local_tensors(x) -> List[torch.Tensor]:
    """A leaf's tensors: a :class:`Sharded`'s locals, else the tensor."""
    return x.locals if isinstance(x, Sharded) else [x]


def leafwise(fn: Callable, x, *others):
    """``fn`` over a leaf's local tensors position by position: a
    :class:`Sharded` in ``x``'s layout, else ``fn(x, *others)``."""
    if isinstance(x, Sharded):
        return x.map(fn, *others)
    return fn(x, *others)


def local_tree(tree, pos: int):
    """Device ``pos``'s local tensors of a tree of :class:`Sharded`
    leaves."""
    return common.tree_map(
        lambda x: x.locals[pos] if isinstance(x, Sharded) else x, tree)


def unstack(tree) -> list:
    """The per-layer trees of a stacked tree (a leading unsplit ``layers``
    axis), as views: a tree of tensors through ``common.unstack``; of
    :class:`Sharded` leaves, each local unbound once, so the backward
    stacks the layers' gradients in one op."""
    flat = common.canonical_flat(tree)
    if not isinstance(next(iter(flat.values())), Sharded):
        return common.unstack(tree)
    parts = {k: [torch.unbind(t) for t in v.locals] for k, v in flat.items()}
    shs = {k: NamedSharding(v.sharding.mesh,
                            PartitionSpec(*v.sharding.spec[1:]))
           for k, v in flat.items()}
    n = len(next(iter(parts.values()))[0])
    return [common.canonical_unflatten(tree, {
        k: Sharded([loc[i] for loc in p], shs[k]) for k, p in parts.items()})
        for i in range(n)]


def shard(t: torch.Tensor, sharding: NamedSharding,
          n: Optional[int] = None):
    """Lay a global tensor out: each device's block copied onto it (a
    copy even where it is already there). Over one device, a plain copy
    on it. ``n``: only the first ``n`` positions' blocks (a count of one
    row of a large mesh on ``meta``, ``layers.Ctx.rows``)."""
    devs = sharding.devices[:n]
    if len(sharding.devices) == 1:
        return t.to(devs[0], copy=True)
    return Sharded([t[sharding.slices(pos, t.shape)].to(d, copy=True)
                    .contiguous() for pos, d in enumerate(devs)], sharding)


def gather(x, device=None) -> torch.Tensor:
    """The global tensor of a :class:`Sharded` on ``device`` (default: its
    first device), each block read from the first position holding it and
    joined by ``torch.cat`` (differentiable). A plain tensor goes to
    ``device`` as it is."""
    if not isinstance(x, Sharded):
        return x if device is None else x.to(device)
    dev = x.locals[0].device if device is None else torch.device(device)
    nd = x.dim()
    parts = x.sharding.parts(nd)
    blocks = {}
    for pos in x.first_of_blocks():
        blocks[x.sharding.block(pos, nd)] = x.locals[pos]
    split = [d for d in range(nd) if parts[d] > 1]

    def join(prefix: Dict[int, int], depth: int):
        if depth == len(split):
            key = tuple(prefix.get(d, 0) for d in range(nd))
            return blocks[key].to(dev)
        d = split[depth]
        return torch.cat([join({**prefix, d: j}, depth + 1)
                          for j in range(parts[d])], dim=d)

    if len(blocks) == 1:
        return join({}, 0)
    # the blocks gathered onto one device: a collective of one receiver
    with kops.collective("all-gather", _nbytes(x.locals[0]) * len(blocks),
                         1):
        return join({}, 0)


def same_blocks(a: NamedSharding, b: NamedSharding, ndim: int) -> bool:
    """Whether two layouts put the same block on each device (a spec that
    names an axis of size 1, as ZeRO's ``data`` in a slice, changes no
    block)."""
    return a.mesh == b.mesh and all(
        a.block(pos, ndim) == b.block(pos, ndim) and
        a.parts(ndim) == b.parts(ndim) for pos in range(a.mesh.size))


def relayout(tree, shardings):
    """Each :class:`Sharded` leaf of ``tree`` in its sharding from
    ``shardings`` (a tree like it): the same local tensors where the new
    layout puts the same blocks on the same devices, else a copy laid out
    again."""
    flat = common.canonical_flat(shardings)

    def one(k, x):
        sh = flat[k]
        if same_blocks(x.sharding, sh, x.dim()):
            return Sharded(x.locals, sh)
        return shard(gather(x), sh)

    return common.canonical_unflatten(tree, {
        k: one(k, x) for k, x in common.canonical_flat(tree).items()})


def _to_layout(leaf, sharding: NamedSharding, n: Optional[int] = None):
    if isinstance(leaf, Sharded):
        if leaf.sharding == sharding:
            return leaf.map(lambda t: t.clone())
        leaf = gather(leaf)
    return shard(leaf, sharding, n)


def device_put(tree, shardings, n: Optional[int] = None):
    """Each leaf of ``tree`` (tensors or :class:`Sharded`) copied into the
    layout of ``shardings`` (a tree of :class:`NamedSharding` like it, or
    one for every leaf); ``n`` as :func:`shard`."""
    if isinstance(shardings, NamedSharding):
        return common.tree_map(lambda t: _to_layout(t, shardings, n), tree)
    flat = common.canonical_flat(shardings)
    return common.canonical_unflatten(tree, {
        k: _to_layout(t, flat[k], n)
        for k, t in common.canonical_flat(tree).items()})


def tree_shardings(axes_tree, mesh, rules: Rules, shapes_tree=None):
    """:func:`tree_partition_specs` as :class:`NamedSharding`\\ s on
    ``mesh``."""
    specs = tree_partition_specs(axes_tree, mesh, rules, shapes_tree)
    return common.tree_map(lambda p: NamedSharding(mesh, p), specs,
                           is_leaf=lambda x: isinstance(x, PartitionSpec))


# ------------------------------------------------------------ collectives

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sum_to(parts: Sequence[torch.Tensor],
            devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The sum of ``parts`` on every one of ``devices``: added in
    position order once on each distinct device, and a copy of it for
    each further position on that device (virtual devices), so every
    position holds its own tensor of the same bits."""
    done: Dict[torch.device, torch.Tensor] = {}
    out = []
    for dev in devices:
        dev = torch.device(dev)
        if dev in done:
            out.append(done[dev].clone())
            continue
        acc = parts[0].to(dev)
        for p in parts[1:]:
            acc = acc + p.to(dev)
        if len(parts) == 1 and acc is parts[0]:
            acc = acc.clone()
        done[dev] = acc
        out.append(acc)
    return out


class _AllReduce(torch.autograd.Function):
    """Each position's sum of the parts; its backward is the all-reduce
    of the positions' gradients, back to each part's device."""

    @staticmethod
    def forward(ctx, devices, *parts):
        ctx.src = [p.device for p in parts]
        ctx.nbytes = _nbytes(parts[0])
        # an output no one used sends no gradient (None, not zeros)
        ctx.set_materialize_grads(False)
        with kops.collective("all-reduce", ctx.nbytes, len(devices)):
            return tuple(_sum_to(parts, devices))

    @staticmethod
    def backward(ctx, *grads):
        grads = [g for g in grads if g is not None]
        if not grads:
            return (None,) * (len(ctx.src) + 1)
        with kops.collective("all-reduce", ctx.nbytes, len(ctx.src)):
            return (None, *_sum_to(grads, ctx.src))


class _AllGather(torch.autograd.Function):
    """The parts joined along ``dim`` on each receiving device. Its
    backward is a reduce-scatter: each part's gradient is its block of
    the sum of the receivers' gradients. ``live`` marks the parts whose
    gradient is wanted (the others stand in for blocks of positions that
    are not computed: their gradient is None)."""

    @staticmethod
    def forward(ctx, dim, devices, live, *parts):
        ctx.dim, ctx.live = dim, live
        ctx.src = [p.device for p in parts]
        ctx.sizes = [p.shape[dim] for p in parts]
        ctx.set_materialize_grads(False)
        with kops.collective("all-gather", sum(_nbytes(p) for p in parts),
                             len(devices)):
            done: Dict[torch.device, torch.Tensor] = {}
            out = []
            for dev in devices:
                dev = torch.device(dev)
                if dev in done:
                    out.append(done[dev].clone())
                else:
                    done[dev] = torch.cat([p.to(dev) for p in parts], dim=dim)
                    out.append(done[dev])
            return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        live = [i for i, w in enumerate(ctx.live) if w]
        out = [None] * len(ctx.src)
        grads = [g for g in grads if g is not None]
        if not grads or not live:
            return (None, None, None, *out)
        block = _nbytes(grads[0]) // max(1, len(ctx.src))
        with kops.collective("reduce-scatter", block, len(live)):
            sums: Dict[torch.device, torch.Tensor] = {}
            for i in live:
                dev = ctx.src[i]
                if dev not in sums:
                    sums[dev] = _sum_to(grads, [dev])[0]
                start = sum(ctx.sizes[:i])
                out[i] = sums[dev].narrow(ctx.dim, start,
                                          ctx.sizes[i]).contiguous()
        return (None, None, None, *out)


def all_reduce(parts: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The sum of ``parts`` (one partial per position) on every position's
    device, added in position order, so every device holds the same bits
    (each position its own tensor: on virtual devices a copy of the one
    sum). Autograd runs through it: the gradient of each part is the
    all-reduce of the positions' gradients. A collective the cost counter
    records (``kernels/ops.collective``)."""
    return list(_AllReduce.apply(list(devices), *parts))


def all_gather(parts: Sequence[torch.Tensor], devices: Sequence[torch.device],
               dim: int, live: Optional[Sequence[bool]] = None
               ) -> List[torch.Tensor]:
    """``parts`` joined along ``dim`` on every position's device;
    differentiable, its backward the reduce-scatter of the gradients to
    the parts (those ``live`` marks, default all)."""
    live = tuple(live) if live is not None else (True,) * len(parts)
    return list(_AllGather.apply(dim, list(devices), live, *parts))


def reduce_scatter(parts: Sequence[torch.Tensor],
                   devices: Sequence[torch.device], dim: int,
                   blocks: Sequence[int], n_blocks: int
                   ) -> List[torch.Tensor]:
    """The sum of ``parts`` (added in position order), of which position
    ``i`` receives block ``blocks[i]`` of ``n_blocks`` along ``dim``: the
    gradient reduction of ZeRO's moment layout. Not differentiable (it
    reduces gradients)."""
    size = parts[0].shape[dim] // n_blocks
    with kops.collective("reduce-scatter", _nbytes(parts[0]) // n_blocks,
                         len(devices)):
        sums: Dict[torch.device, torch.Tensor] = {}
        out = []
        for dev, b in zip(devices, blocks):
            dev = torch.device(dev)
            if dev not in sums:
                acc = parts[0].to(dev)
                for p in parts[1:]:
                    acc = acc + p.to(dev)
                sums[dev] = acc
            out.append(sums[dev].narrow(dim, b * size, size).contiguous())
    return out


def axis_groups(mesh, axes: Sequence[str], n: Optional[int] = None
                ) -> List[List[int]]:
    """The groups of flat positions (the first ``n``, default all) that
    differ only along ``axes``: a collective over those mesh axes runs
    within each group, its members in position order."""
    n = mesh.size if n is None else n
    names = list(mesh.axis_names)
    groups: Dict[tuple, List[int]] = {}
    for pos in range(n):
        coords = np.unravel_index(pos, tuple(mesh.shape[a] for a in names))
        key = tuple(int(c) for a, c in zip(names, coords) if a not in axes)
        groups.setdefault(key, []).append(pos)
    return list(groups.values())


def sum_replica_grads(g: Sharded, moments: Optional[NamedSharding] = None
                      ) -> Sharded:
    """The gradient of a leaf whose blocks have replicas: each replica's
    tensor received the gradient of its own device's uses, and the
    block's gradient is their sum (the all-reduce GSPMD inserts for a
    replicated parameter, over ``model`` and over the ``data`` / ``pod``
    rows alike), added in position order and given to every replica.
    With ``moments`` (ZeRO's layout of the moments, which splits a dim
    the parameter replicates over ``data``), a reduce-scatter instead:
    each position receives its moment block of the sum. Positions past
    the locals (a count of one row, ``layers.Ctx.rows``) take no part."""
    nd = g.dim()
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for pos in range(len(g.locals)):
        groups.setdefault(g.sharding.block(pos, nd), []).append(pos)
    out = list(g.locals)
    scatter = None
    if moments is not None and not same_blocks(g.sharding, moments, nd):
        pp, mp = g.sharding.parts(nd), moments.parts(nd)
        diff = [d for d in range(nd) if pp[d] != mp[d]]
        if len(diff) == 1:
            scatter = (diff[0], mp[diff[0]] // pp[diff[0]])
    # replicas of each block in the whole mesh (some may not be computed)
    replicas = g.sharding.mesh.size // math.prod(g.sharding.parts(nd))
    for members in groups.values():
        devs = [g.locals[p].device for p in members]
        parts = [g.locals[p] for p in members]
        if scatter is not None:
            d, k = scatter
            blocks = [moments.block(p, nd)[d] % k for p in members]
            res = reduce_scatter(parts, devs, d, blocks, k)
        elif replicas > 1:
            res = all_reduce(parts, devs)
        else:
            continue
        for p, s in zip(members, res):
            out[p] = s
    return Sharded(out, moments if scatter is not None else g.sharding)


def constrain(x, mesh, rules: Rules, axes: Sequence[Optional[str]]):
    """Bring an activation to the layout its logical ``axes`` resolve to on
    ``mesh`` (where the reference calls ``with_sharding_constraint``): a
    list of per-device tensors, each holding its data row's block of the
    value (the batch over ``pod`` x ``data``, a cache's sequence over
    ``data``), is sliced along the model axis where it lies; a
    :class:`Sharded` is gathered first. Returns the per-device tensors of
    the new layout; outside a mesh of several devices, ``x`` as it is."""
    if mesh is None or mesh.size == 1 or torch.is_tensor(x):
        return x
    if isinstance(x, Sharded):
        shape, glob = x.shape, gather(x)
        src = [glob.to(d) for d in mesh.flat_devices()]
        sh = NamedSharding(mesh, resolve(axes, mesh, rules, shape=shape))
    else:
        # each device's tensor is already its block along the axes over
        # ``data`` and ``pod`` (a batch, a cache's sequence): only the
        # model axis is left to slice
        src, shape = list(x), x[0].shape
        spec = resolve(axes, mesh, rules, shape=shape)
        sh = NamedSharding(mesh, PartitionSpec(*(
            e if "model" in _mesh_axes_tuple(e) else None for e in spec)))
    return [t[sh.slices(pos, shape)] for pos, t in enumerate(src)]
