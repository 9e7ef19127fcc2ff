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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
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


def route(router, cfg: ModelConfig, x):
    """x: (B, S, d) -> (gates (B, S, k) f32, expert ids (B, S, k), aux).

    Top-k by a stable descending sort, so equal probabilities go to the
    lower expert id first, as ``jax.lax.top_k``. Each token's k choices
    then come in ascending expert id (the combine's order)."""
    k, e = cfg.experts_per_token, cfg.num_experts
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


def moe_apply(p, cfg: ModelConfig, x):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    b, s, d = x.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    cap = expert_capacity(cfg, s)
    gate_w, expert_ids, aux = route(p["router"], cfg, x)
    pos = slot_ranks(expert_ids, e)
    keep = pos < cap

    # dispatch: buffer row (expert, batch row, rank); a dropped choice
    # writes into one spare row past the end, which nothing reads
    rows = torch.arange(b, device=x.device)[:, None, None]
    slot = torch.where(keep, (expert_ids * b + rows) * cap + pos,
                       e * b * cap)
    buf = x.new_zeros((e * b * cap + 1, d))
    buf[slot.reshape(-1)] = x[:, :, None, :].expand(b, s, k, d).reshape(-1, d)
    buf = buf[:-1].view(e, b * cap, d)

    # expert compute: batched GEMMs over the experts axis
    h = F.silu(torch.bmm(buf, p["wi_gate"])) * torch.bmm(buf, p["wi_up"])
    out_buf = torch.bmm(h, p["wo"]).view(e * b * cap, d)

    # combine: gather back, weight by the bf16 gates, sum in expert order
    eo = out_buf[torch.where(keep, slot, 0)]
    eo = torch.where(keep[..., None], eo, 0)
    contrib = eo * gate_w.to(eo.dtype)[..., None]
    out = contrib[:, :, 0]
    for j in range(1, k):
        out = out + contrib[:, :, j]
    return out.to(x.dtype), aux
