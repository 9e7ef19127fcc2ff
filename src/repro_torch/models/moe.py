"""Token-choice top-k Mixture-of-Experts FFN (capacity-based dispatch).

The port of ``repro.models.moe``: f32 router, top-k gates renormalised,
the Switch-style load-balancing loss plus a router z-loss, and BATCH-LOCAL
dispatch: each batch row ranks its own ``s * k`` choices within their
expert (a stable sort by expert id, as the reference's
``argsort(stable=True)``) and drops the ranks at or past the capacity.
The expert products are batched GEMMs over the experts axis, as the
reference's einsums, so a step reads every expert's weights (a grouped
GEMM over the routed experts is ROADMAP.md Queue 2).

Two choices keep the result repeatable where the reference relies on
scatter-adds:

- the dispatch buffer is written by plain indexing, each kept slot once
  (the reference adds the kept rows into zeros and adds zeros for the
  dropped ones at slot 0, which gives the same values);
- the combine sums each token's k weighted expert outputs in bf16, one
  add at a time, in ascending expert id: the order in which the
  reference's ``.at[src].add`` over the expert-sorted choices meets them,
  and with no atomics, so every run on a device gives the same bits.

The buffer is laid out (experts, batch, capacity, d_model), so each expert
GEMM is one ``bmm`` over the experts axis without a transpose; the
reference's (batch, experts, capacity, d_model) holds the same rows.

Over a slice of several devices (a ``ctx``, ``models/layers.py``) the
layout is the reference's ``RULES_TP``: where the experts divide the
slice, the router's columns and the expert weights split over experts
(expert parallelism). Each device's block of router logits is gathered to
every device before the softmax and top-k, so every device routes alike;
each device fills only its own experts' rows of the buffer (the
reference's "scatter replicated, then slice", ``repro/models/moe.py:
104-112``) and runs the GEMMs over its experts; the expert outputs are
gathered back to every device (the reference's explicit gather, ``:135-
138``) and combined as on one device. Where the experts do not divide the
slice the rules leave the expert weights replicated, and each device
computes the whole MoE from its copy. The aux loss is the first device's,
so a loss counts it once.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.models import sharding as shd
from repro_torch.models.common import spec


def moe_param_specs(cfg: ModelConfig):
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    return {
        "router": spec((d, e), ("embed", "experts"), dtype=torch.float32),
        "wi_gate": spec((e, d, f), ("experts", "embed", "expert_mlp")),
        "wi_up": spec((e, d, f), ("experts", "embed", "expert_mlp")),
        "wo": spec((e, f, d), ("experts", "expert_mlp", "embed")),
    }


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    per = n_tokens * cfg.experts_per_token / cfg.num_experts
    return max(8, int(math.ceil(per * cfg.capacity_factor / 8.0)) * 8)


def route(router, cfg: ModelConfig, x, logits=None):
    """x: (B, S, d) -> (gates (B, S, k) f32, expert ids (B, S, k), aux).

    Top-k by a stable descending sort, so equal probabilities go to the
    lower expert id first, as ``jax.lax.top_k``. Each token's k choices
    then come in ascending expert id (the combine's order). ``logits``:
    the f32 router logits where they are already made (a slice gathers
    them), else ``x``'s product with ``router``."""
    k, e = cfg.experts_per_token, cfg.num_experts
    if logits is None:
        logits = x.float() @ router
    probs = torch.softmax(logits, dim=-1)
    gate_w, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    gate_w, expert_ids = gate_w[..., :k], expert_ids[..., :k]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # load-balancing aux loss (Switch-style) + router z-loss
    # (bincount would read the largest id back to the host on a card)
    me = probs.mean((0, 1))
    flat = expert_ids.reshape(-1)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device) \
        .scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.float32)) \
        / flat.numel()
    aux = e * torch.sum(me * ce)
    aux = aux + 1e-3 * torch.mean(torch.square(
        torch.logsumexp(logits, dim=-1)))

    expert_ids, perm = torch.sort(expert_ids, dim=-1)
    return torch.gather(gate_w, -1, perm), expert_ids, aux


def slot_ranks(expert_ids, e: int):
    """Each choice's rank within its expert, per batch row: its place in
    the row's (token, slot) choices stably sorted by expert id.
    expert_ids: (B, S, k) -> (B, S, k) int64."""
    b = expert_ids.shape[0]
    flat = expert_ids.reshape(b, -1)
    sorted_eid, order = torch.sort(flat, dim=-1, stable=True)
    counts = torch.zeros((b, e), dtype=torch.long, device=flat.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    offsets = torch.cumsum(counts, dim=-1) - counts
    pos_sorted = torch.arange(flat.shape[1], device=flat.device) \
        - torch.gather(offsets, 1, sorted_eid)
    return torch.empty_like(flat).scatter_(1, order, pos_sorted) \
        .reshape(expert_ids.shape)


def _slots(expert_ids, pos, keep, b: int, cap: int, e0: int, el: int,
            e: int):
    """Each choice's buffer row (expert - e0, batch row, rank) among the
    ``el`` experts from ``e0``; a dropped choice, or one of another
    device's experts, goes to one spare row past the end, which nothing
    reads."""
    rows = torch.arange(b, device=expert_ids.device)[:, None, None]
    mine = keep if el == e else \
        keep & (expert_ids >= e0) & (expert_ids < e0 + el)
    return torch.where(mine, ((expert_ids - e0) * b + rows) * cap + pos,
                       el * b * cap)


def _experts(p, x, slot, n_experts: int, b: int, cap: int):
    """Dispatch ``x`` (B, S, d) into the buffer rows ``slot`` and run the
    expert GEMMs, batched over the ``n_experts`` experts of ``p``:
    (n_experts * b * cap, d)."""
    bb, s, d = x.shape
    k = slot.shape[-1]
    buf = x.new_zeros((n_experts * b * cap + 1, d))
    buf[slot.reshape(-1)] = x[:, :, None, :].expand(bb, s, k, d) \
        .reshape(-1, d)
    buf = buf[:-1].view(n_experts, b * cap, d)
    h = F.silu(torch.bmm(buf, p["wi_gate"])) * torch.bmm(buf, p["wi_up"])
    return torch.bmm(h, p["wo"]).view(n_experts * b * cap, d)


def _combine(out_buf, slot, keep, gate_w, k: int, dtype):
    """Gather each choice's expert output back, weight it by its bf16
    gate and sum a token's k in expert order."""
    eo = out_buf[torch.where(keep, slot, 0)]
    eo = torch.where(keep[..., None], eo, 0)
    contrib = eo * gate_w.to(eo.dtype)[..., None]
    out = contrib[:, :, 0]
    for j in range(1, k):
        out = out + contrib[:, :, j]
    return out.to(dtype)


def moe_apply(p, cfg: ModelConfig, x, ctx=None):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar). With ``ctx``,
    ``x`` and ``out`` are per-device lists over the slice."""
    if ctx is not None:
        return _moe_apply_tp(p, cfg, x, ctx)
    b, s, d = x.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    cap = expert_capacity(cfg, s)
    gate_w, expert_ids, aux = route(p["router"], cfg, x)
    pos = slot_ranks(expert_ids, e)
    keep = pos < cap
    slot = _slots(expert_ids, pos, keep, b, cap, 0, e, e)
    out_buf = _experts(p, x, slot, e, b, cap)
    return _combine(out_buf, slot, keep, gate_w, k, x.dtype), aux


def _moe_apply_tp(p, cfg: ModelConfig, xs, ctx):
    """:func:`moe_apply` over the slice (module docstring). Returns the
    per-device outputs and the aux loss: the first device's, or over data
    rows the mean of each row's first device's, all-reduced over
    ``data`` (every row routes its own block of the batch)."""
    p = ctx.view(p)
    if not shd.splits(p["wi_gate"], 0):
        # the experts do not divide the slice: the whole MoE on every
        # device, from its copy of the replicated weights
        outs = [moe_apply(shd.local_tree(p, r), cfg, xr)
                for r, xr in enumerate(xs)]
        return [o for o, _ in outs], _row_aux(ctx, [a for _, a in outs])
    b, s, _ = xs[0].shape
    k, e = cfg.experts_per_token, cfg.num_experts
    el = p["wi_gate"].locals[0].shape[0]
    cap = expert_capacity(cfg, s)
    parts = [xr.float() @ p["router"].locals[r] for r, xr in enumerate(xs)]
    logits = ctx.all_gather(parts, -1)
    routes, bufs = [], []
    for r, xr in enumerate(xs):
        gate_w, ids, aux = route(None, cfg, xr, logits=logits[r])
        pos = slot_ranks(ids, e)
        keep = pos < cap
        e0 = p["wi_gate"].sharding.block(r, 3)[0] * el
        slot = _slots(ids, pos, keep, b, cap, e0, el, e)
        bufs.append(_experts(shd.local_tree(p, r), xr, slot, el, b, cap))
        routes.append((gate_w, ids, pos, keep, aux))
    out_bufs = ctx.all_gather(bufs, 0)
    outs = []
    for r, (gate_w, ids, pos, keep, _) in enumerate(routes):
        slot = _slots(ids, pos, keep, b, cap, 0, e, e)
        outs.append(_combine(out_bufs[r], slot, keep, gate_w, k,
                             xs[r].dtype))
    return outs, _row_aux(ctx, [rt[4] for rt in routes])


def _row_aux(ctx, auxs):
    """The aux loss of a slice's MoE: its first device's; over data rows,
    a list with each row's: the rows' first devices' losses averaged by
    an all-reduce over ``data`` (the same bits on every row)."""
    if not ctx.dp:
        return auxs[0]
    firsts = ctx.row_starts()
    summed = shd.all_reduce([auxs[r] for r in firsts],
                            [ctx.devices[r] for r in firsts])
    return [t / ctx.n_rows for t in summed]
