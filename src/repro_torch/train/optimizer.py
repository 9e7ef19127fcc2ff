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
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models import common
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
    flat = common.canonical_flat(params)
    device = next(iter(flat.values())).device

    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

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
    leaves = [_square_sum(g) for g in common.canonical_flat(tree).values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def update_(grads, state: AdamWState, params,
            cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step IN PLACE: the new parameters, moments and step are
    written into ``params`` and ``state``'s tensors. Returns the metrics.
    The arithmetic is elementwise, so the slices change no value."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip else 1.0
    step = state.step + 1
    lr = _schedule(cfg, state.step)
    c1 = 1.0 - cfg.b1 ** step.float()
    c2 = 1.0 - cfg.b2 ** step.float()

    def upd(g, m, v, p):
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
    for k, p in flat[3].items():
        leaf = [f[k] for f in flat]
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
    state.step.copy_(step)
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
