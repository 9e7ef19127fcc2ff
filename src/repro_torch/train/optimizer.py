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

Over a slice of several devices the leaves are ``Sharded``: the step runs
per local tensor, position by position (the moments' layout is the
parameters' with ZeRO's ``data`` axis, 1 in a slice), and the global
norm reads each block once.
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
    """The f32 norm of every leaf together: a ``Sharded`` leaf's blocks
    each read once, the sums on the first leaf's device."""
    leaves = []
    for g in common.canonical_flat(tree).values():
        if isinstance(g, shd.Sharded):
            leaves += [_square_sum(g.locals[i]) for i in g.first_of_blocks()]
        else:
            leaves.append(_square_sum(g))
    dev = leaves[0].device
    return torch.sqrt(torch.sum(torch.stack([t.to(dev) for t in leaves])))


def update_(grads, state: AdamWState, params,
            cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step IN PLACE: the new parameters, moments and step are
    written into ``params`` and ``state``'s tensors. Returns the metrics.
    The arithmetic is elementwise, so the slices change no value."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip else 1.0
    step_t = shd.local_tensors(state.step)
    step = step_t[0] + 1
    lr = _schedule(cfg, step_t[0])
    c1 = 1.0 - cfg.b1 ** step.float()
    c2 = 1.0 - cfg.b2 ** step.float()
    on_dev = {}

    def scalars(dev):
        """scale, lr, c1 and c2 on ``dev`` (once each)."""
        if dev not in on_dev:
            on_dev[dev] = [x.to(dev) if torch.is_tensor(x) else x
                           for x in (scale, lr, c1, c2)]
        return on_dev[dev]

    def upd(g, m, v, p):
        scale, lr, c1, c2 = scalars(p.device)
        g = g.float() * scale
        m32, v32 = m.float(), v.float()
        m_new = cfg.b1 * m32 + (1 - cfg.b1) * g
        v_new = cfg.b2 * v32 + (1 - cfg.b2) * torch.square(g)
        mhat = m_new / c1
        vhat = v_new / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        p_new = p.float() - lr * delta
        return p_new, m_new, v_new

    flat = [common.canonical_flat(t)
            for t in (grads, state.mu, state.nu, params)]
    for k in flat[3]:
        for leaf in zip(*(shd.local_tensors(f[k]) for f in flat)):
            p = leaf[3]
            if p.dim() == 0:
                slices = [leaf]
            else:
                rows = max(1, _SLICE_ELEMS // max(1, p[0].numel()))
                slices = zip(*(t.split(rows) for t in leaf))
            for g, m, v, pp in slices:
                p_new, m_new, v_new = upd(g, m, v, pp)
                pp.copy_(p_new)
                m.copy_(m_new)
                v.copy_(v_new)
    for t in step_t:
        t.copy_(step)
    return {"grad_norm": gnorm, "lr": lr}


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
