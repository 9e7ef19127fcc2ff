"""AdamW over the model's parameter trees (port of
``repro.train.optimizer``, ``:23-97``).

The step keeps the reference's semantics exactly: the learning rate comes
from the step count BEFORE the update (linear warmup), the bias
corrections from the count after it; gradients are clipped by their
global norm (squares summed in f32); parameters update in f32 and are cast
back to their dtype, the moments kept in ``moment_dtype``. The ZeRO
moment specs (:func:`zero_moment_spec`, :func:`state_partition_specs`) are
the reference's logic over shapes (``models/sharding.py``).

:func:`update_` is the step: unlike the reference's ``update``, which
returns new trees, it writes the new values into the parameter and moment
tensors it is given, leaf by leaf and, within a leaf, in slices along the
leading (layer) axis, so the f32 temporaries are those of one slice. New
trees would hold a second copy of the whole train state: 27 GB at
mamba2-2.7b. A caller that wants the inputs kept clones them first.

Over a mesh the leaves are ``Sharded`` and each device runs the step on
its local tensors (:func:`_update_mesh_`; in a slice the moments' layout
is the parameters' with ZeRO's ``data`` axis of 1). With data rows the
step is ZeRO-2's: each device updates its ``data`` block of a parameter
from its block of the moments and gradient, and an all-gather over
``data`` completes the parameter.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models import common
from repro_torch.models import sharding as shd
from repro_torch.models.sharding import PartitionSpec as P


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-5
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    warmup_steps: int = 10
    # moments dtype: f32 is the safe default; bf16 halves optimizer memory
    moment_dtype: torch.dtype = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor           # 0-d int32, on the parameters' device
    mu: Any
    nu: Any


def init(params, cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    """Zero moments beside each parameter (``Sharded`` ones in its layout)
    and the step on the first parameter's device."""
    flat = common.canonical_flat(params)
    device = next(iter(flat.values())).device

    def zeros(p):
        return shd.leafwise(lambda t: torch.zeros(
            t.shape, dtype=cfg.moment_dtype, device=t.device), p)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=common.tree_map(zeros, params),
        nu=common.tree_map(zeros, params),
    )


def _schedule(cfg: AdamWConfig, step):
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


# the most elements of one slice of an in-place update (at least one row
# of the leading axis: one layer of a stacked leaf)
_SLICE_ELEMS = 1 << 26


def _square_sum(g):
    """sum(g**2) in f32; squares an f32 copy of a low-precision leaf in
    place rather than making a second one."""
    g32 = g.float()
    return torch.sum(torch.square(g32) if g32 is g else g32.square_())


def global_norm(tree):
    """The f32 norm of every leaf together, the sums on the first leaf's
    device."""
    leaves = [_square_sum(g) for g in common.canonical_flat(tree).values()]
    dev = leaves[0].device
    return torch.sqrt(torch.sum(torch.stack([t.to(dev) for t in leaves])))


def _mesh(tree):
    """The mesh of a tree's ``Sharded`` leaves, else None."""
    for x in common.canonical_flat(tree).values():
        if isinstance(x, shd.Sharded):
            return x.sharding.mesh
    return None


def _scalars(cfg: AdamWConfig, gnorm, count):
    """The clip scale, learning rate and bias corrections of the step after
    ``count`` steps, and the new count."""
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip else 1.0
    step = count + 1
    return (scale, _schedule(cfg, count), 1.0 - cfg.b1 ** step.float(),
            1.0 - cfg.b2 ** step.float()), step


def _adamw(cfg: AdamWConfig, g, m, v, p, scale, lr, c1, c2):
    """One AdamW step of a leaf's elements: the new parameter (f32), mu and
    nu."""
    g = g.float() * scale
    m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g
    v_new = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
    delta = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
    if cfg.weight_decay:
        delta = delta + cfg.weight_decay * p.float()
    return p.float() - lr * delta, m_new, v_new


def _step_(cfg: AdamWConfig, leaf, scalars):
    """Write :func:`_adamw`'s step of one leaf's (g, mu, nu, param) into its
    mu, nu and param, in slices along the leading axis."""
    p = leaf[3]
    if p.dim() == 0:
        slices = [leaf]
    else:
        rows = max(1, _SLICE_ELEMS // max(1, p[0].numel()))
        slices = zip(*(t.split(rows) for t in leaf))
    for g, m, v, pp in slices:
        p_new, m_new, v_new = _adamw(cfg, g, m, v, pp, *scalars)
        pp.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)


def update_(grads, state: AdamWState, params,
            cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step IN PLACE: the new parameters, moments and step are
    written into ``params`` and ``state``'s tensors. Returns the metrics.
    The arithmetic is elementwise, so the slices change no value. Over a
    mesh, each device's step (:func:`_update_mesh_`)."""
    if _mesh(params) is not None:
        return _update_mesh_(grads, state, params, cfg)
    gnorm = global_norm(grads)
    scalars, step = _scalars(cfg, gnorm, state.step)
    on_dev = {}
    flat = [common.canonical_flat(t)
            for t in (grads, state.mu, state.nu, params)]
    for k in flat[3]:
        leaf = tuple(f[k] for f in flat)
        dev = leaf[3].device
        if dev not in on_dev:
            on_dev[dev] = [x.to(dev) if torch.is_tensor(x) else x
                           for x in scalars]
        _step_(cfg, leaf, on_dev[dev])
    state.step.copy_(step)
    return {"grad_norm": gnorm, "lr": scalars[1]}


def _update_mesh_(grads, state: AdamWState, params, cfg: AdamWConfig):
    """:func:`update_` over a mesh, each device its own step. With data
    rows it is ZeRO-2's (``zero_moment_spec``): each device holds its
    ``data`` block of ``mu`` and ``nu`` and of the gradient
    (``grpo.compute_grads`` reduce-scatters it so), updates the matching
    block of its parameter, and an all-gather over ``data`` completes the
    parameter where its spec replicates it there; a parameter split over
    ``data`` (the embed dim under ``fsdp_tp``) keeps its block. Every
    device runs the same program: the global norm sums each leaf's square
    sums by an all-reduce over the axes its gradient splits (each block
    once), in position order; the step count, learning rate and bias
    corrections are each device's own. The positions computed are those
    the gradient holds (one row of a large mesh on ``meta``:
    ``layers.Ctx.rows``)."""
    flat = [common.canonical_flat(t)
            for t in (grads, state.mu, state.nu, params)]
    keys = list(flat[3])
    n = len(flat[0][keys[0]].locals)
    mesh = flat[3][keys[0]].sharding.mesh
    devs = mesh.flat_devices()[:n]
    # the global norm, on every position
    tot = [None] * n
    for k in keys:
        g = flat[0][k]
        sq = [_square_sum(t) for t in g.locals[:n]]
        axes = [a for e in g.sharding.spec
                for a in shd._mesh_axes_tuple(e)]
        for grp in shd.axis_groups(mesh, axes, n):
            got = shd.all_reduce([sq[q] for q in grp],
                                 [devs[q] for q in grp]) \
                if axes else [sq[grp[0]]]
            for q, t in zip(grp, got):
                tot[q] = t if tot[q] is None else tot[q] + t
    step_t = shd.local_tensors(state.step)
    gnorms = [torch.sqrt(t) for t in tot]
    per_pos = [_scalars(cfg, gnorms[q], step_t[q]) for q in range(n)]
    for k in keys:
        g, mu, nu, p = (f[k] for f in flat)
        nd = p.dim()
        pp, mp = p.sharding.parts(nd), mu.sharding.parts(nd)
        zd = [d for d in range(nd) if pp[d] != mp[d]]
        for q in range(n):
            pq = p.locals[q]
            if zd:
                d = zd[0]
                size = mu.locals[q].shape[d]
                b = mu.sharding.block(q, nd)[d] % (mp[d] // pp[d])
                pq = pq.narrow(d, b * size, size)
            _step_(cfg, (g.locals[q], mu.locals[q], nu.locals[q], pq),
                   per_pos[q][0])
        if zd:
            _gather_zero_blocks(p, mu, zd[0], n)
    for q, t in enumerate(step_t[:n]):
        t.copy_(per_pos[q][1])
    return {"grad_norm": gnorms[0], "lr": per_pos[0][0][1]}


def _gather_zero_blocks(p: shd.Sharded, mu: shd.Sharded, d: int, n: int):
    """After the update of each device's ZeRO block of ``p`` (along dim
    ``d``, ``mu``'s blocks), the all-gather over ``data``: every replica's
    other blocks written from the devices that updated them (a position
    not computed stands in by one that is, of the same shapes)."""
    nd = p.dim()
    k = mu.sharding.parts(nd)[d] // p.sharding.parts(nd)[d]
    size = mu.locals[0].shape[d]
    devs = p.sharding.mesh.flat_devices()
    for grp in shd.axis_groups(p.sharding.mesh, ("data",)):
        here = [q for q in grp if q < n]
        if not here:
            continue
        src = {}
        for q in grp:
            b = mu.sharding.block(q, nd)[d] % k
            src.setdefault(b, q if q < n else here[0])
        parts = [p.locals[src[b]].narrow(d, b * size, size)
                 for b in range(k)]
        with torch.no_grad():
            got = shd.all_gather(parts, [devs[q] for q in here], d)
        for q, t in zip(here, got):
            p.locals[q].copy_(t)


# ------------------------------------------------------------- ZeRO specs

def zero_moment_spec(param_spec: P, shape, mesh, zero_axis: str = "data") -> P:
    """Derive a moment PartitionSpec: param spec + ``zero_axis`` on the first
    divisible unsharded dim (ZeRO-2 moment sharding)."""
    if zero_axis not in mesh.axis_names:
        return param_spec
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    used = set()
    for e in entries:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a:
                used.add(a)
    if zero_axis in used:
        return param_spec
    n = mesh.shape[zero_axis]
    for i, e in enumerate(entries):
        if e is None and shape[i] % n == 0 and shape[i] >= n:
            entries[i] = zero_axis
            while entries and entries[-1] is None:
                entries.pop()
            return P(*entries)
    return param_spec


def state_partition_specs(param_pspecs, abstract_params, mesh,
                          zero: bool = True) -> AdamWState:
    """PartitionSpecs for the full AdamWState."""
    if zero:
        shapes = common.canonical_flat(abstract_params)
        mom = common.canonical_unflatten(param_pspecs, {
            k: zero_moment_spec(ps, shapes[k].shape, mesh)
            for k, ps in common.canonical_flat(param_pspecs).items()})
    else:
        mom = param_pspecs
    return AdamWState(step=P(), mu=mom, nu=mom)
