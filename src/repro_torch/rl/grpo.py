"""GRPO (group-relative policy optimization) objective and step builders.

The port of ``repro.rl.grpo``: the ``compute_log_prob`` (forward) and
``update_actor`` (forward, backward, AdamW) primitives PlexRL schedules
(paper Tab. 2). Parameters are the model's nested-dict trees. Gradients
come from ``torch.autograd.grad`` over detached copies of the leaves that
require grad, so the stored tensors never join a graph; attention's
gradient is the JAX package's XLA autodiff (``kernels/ops.py``).

Over a slice of several devices (a ``ctx``) the parameters are
``Sharded`` leaves and the model runs tensor-parallel; the logits are
gathered to the slice's first device, and the loss is computed there.
Over data rows each row's first device takes its block's masked sums, an
all-reduce over ``data`` adds them, and the gradients come back in
ZeRO-2's layout (reduce-scattered over ``data``).
Autograd runs through the collectives' copies and sums, so each local
tensor gets its gradient; a replicated leaf's copies each get the
gradient of their own device's uses, and :func:`value_and_grad` sums them
(``sharding.sum_replica_grads``), the all-reduce GSPMD inserts.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models import common
from repro_torch.models import sharding as shd
from repro_torch.models.registry import Model
from repro_torch.train import optimizer as opt
from repro_torch.train.train_state import TrainState


@dataclasses.dataclass(frozen=True)
class GRPOConfig:
    clip_eps: float = 0.2
    kl_coef: float = 0.0        # optional KL vs behavior policy
    aux_coef: float = 0.01      # MoE load-balance weight
    group_size: int = 8         # rollouts per prompt


def token_logprobs(logits, tokens):
    """logits: (B, S, V); tokens: (B, S). Next-token logprobs (B, S-1), in
    f32: the picked logit less the row's logsumexp, which is
    ``log_softmax`` then ``take_along_axis`` without a second (B, S-1, V)
    tensor."""
    lg = logits[:, :-1].float()
    picked = torch.gather(lg, -1, tokens[:, 1:, None].long())[..., 0]
    return picked - torch.logsumexp(lg, dim=-1)


def group_relative_advantages(rewards, group_size: int, eps: float = 1e-6):
    """rewards: (B,) with B = n_prompts * group_size (grouped contiguously).
    The std is the population std, as ``jnp.std``."""
    b = rewards.shape[0]
    g = rewards.reshape(b // group_size, group_size)
    mean = g.mean(dim=1, keepdim=True)
    std = g.std(dim=1, keepdim=True, correction=0)
    return ((g - mean) / (std + eps)).reshape(b)


def grpo_loss(params, model: Model, batch: Dict[str, Any], cfg: GRPOConfig,
              ctx=None):
    """Clipped importance-sampling surrogate with group-relative advantages.

    batch: tokens (B,S), behavior_logprobs (B,S), advantages (B,),
    loss_mask (B,S); the mask selects response tokens.
    """
    logits, aux = model.forward(params, batch, ctx=ctx)[:2]
    if isinstance(logits, list):
        return _grpo_loss_rows(logits, aux, batch, cfg, ctx)
    logp = token_logprobs(logits, batch["tokens"])           # (B, S-1)
    del logits
    behave = batch["behavior_logprobs"][:, 1:]
    mask = batch["loss_mask"][:, 1:]
    adv = batch["advantages"][:, None]

    log_ratio = logp - behave
    ratio = torch.exp(log_ratio)
    clipped = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps)
    surrogate = torch.minimum(ratio * adv, clipped * adv)
    denom = torch.clamp(mask.sum(), min=1.0)
    pg_loss = -(surrogate * mask).sum() / denom
    # k3 KL estimator, log_ratio clamped so an off-policy outlier cannot
    # overflow exp() into inf (0 * inf would NaN the loss at kl_coef == 0)
    lr_c = torch.clamp(log_ratio, -20.0, 20.0)
    kl = ((torch.exp(-lr_c) - 1.0 + lr_c) * mask).sum() / denom
    loss = pg_loss + cfg.aux_coef * aux
    if cfg.kl_coef:
        loss = loss + cfg.kl_coef * kl
    metrics = {
        "pg_loss": pg_loss,
        "kl": kl,
        "aux": aux,
        "ratio_mean": (ratio * mask).sum() / denom,
        "entropy_proxy": -(logp * mask).sum() / denom,
    }
    return loss, metrics


def _grpo_loss_rows(logits, aux, batch, cfg: GRPOConfig, ctx):
    """:func:`grpo_loss` over data rows: each row's first device holds
    its block of the batch's logits and takes the masked sums of its
    rows; an all-reduce over ``data`` adds them, so every row computes
    the loss and the metrics of the whole batch (the same bits on each).
    Returns each row's loss over the rows' count (a list: the backward
    starts on every row from its own, and their sum is the loss) and the
    first row's metrics."""
    b = batch["tokens"].shape[0]
    firsts = ctx.row_starts()
    if ctx.batch_slice(b, 0).stop == b:
        raise ValueError(f"a batch of {b} does not split over "
                         f"{ctx.n_rows} data rows")
    sums, devs = [], []
    for i, r0 in enumerate(firsts):
        lg = logits[i]
        dev = lg.device
        sl = ctx.batch_slice(b, r0)
        tokens = batch["tokens"][sl].to(dev)
        logp = token_logprobs(lg, tokens)
        behave = batch["behavior_logprobs"][sl, 1:].to(dev)
        mask = batch["loss_mask"][sl, 1:].to(dev)
        adv = batch["advantages"][sl, None].to(dev)
        log_ratio = logp - behave
        ratio = torch.exp(log_ratio)
        clipped = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps)
        surrogate = torch.minimum(ratio * adv, clipped * adv)
        lr_c = torch.clamp(log_ratio, -20.0, 20.0)
        kl = torch.exp(-lr_c) - 1.0 + lr_c
        sums.append(torch.stack([(surrogate * mask).sum(), mask.sum(),
                                 (kl * mask).sum(), (ratio * mask).sum(),
                                 -(logp * mask).sum()]))
        devs.append(dev)
    tot = shd.all_reduce(sums, devs)
    losses, metrics = [], None
    for i, t in enumerate(tot):
        denom = torch.clamp(t[1], min=1.0)
        pg_loss = -t[0] / denom
        kl = t[2] / denom
        a = aux[i] if isinstance(aux, list) else aux.to(devs[i])
        loss = pg_loss + cfg.aux_coef * a
        if cfg.kl_coef:
            loss = loss + cfg.kl_coef * kl
        losses.append(loss / ctx.n_rows)
        # every row computes the metrics (the same program on each); the
        # first row's are returned
        m = {"pg_loss": pg_loss, "kl": kl, "aux": a,
             "ratio_mean": t[3] / denom, "entropy_proxy": t[4] / denom}
        metrics = metrics or m
    return losses, metrics


def value_and_grad(loss_fn, params):
    """Flat {key: grad} of ``loss_fn(params) -> (loss, metrics)`` (zeros for
    an unused leaf, as ``jax.grad``) and the metrics with the loss, all
    detached. ``loss`` may be a list of shares (one a data row), whose
    sum is differentiated. A ``Sharded`` leaf's gradient is ``Sharded`` in its layout,
    its replicas' gradients summed."""
    leaves = {k: shd.leafwise(lambda t: t.detach().requires_grad_(), p)
              for k, p in common.canonical_flat(params).items()}
    tensors = [t for p in leaves.values() for t in shd.local_tensors(p)]
    loss, metrics = loss_fn(common.canonical_unflatten(params, leaves))
    got = iter(torch.autograd.grad(loss, tensors, allow_unused=True))
    if isinstance(loss, list):
        # over data rows, each row's share: the loss is their sum, every
        # row's all-reduced copy the same
        loss = shd.all_reduce([t.detach() for t in loss],
                              [t.device for t in loss])[0]

    def grad_of(t):
        g = next(got)
        return torch.zeros_like(t) if g is None else g

    grads = {}
    for k, p in leaves.items():
        grads[k] = shd.sum_replica_grads(p.map(grad_of), _zero(p)) \
            if isinstance(p, shd.Sharded) else grad_of(p)
    metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
    return grads, metrics


def _zero(p: shd.Sharded):
    """ZeRO-2's layout of a leaf's moments and gradient on a mesh with
    data rows (``optimizer.zero_moment_spec``), else None."""
    mesh = p.sharding.mesh
    if mesh.shape.get("data", 1) == 1:
        return None
    return shd.NamedSharding(mesh, opt.zero_moment_spec(
        p.sharding.spec, tuple(p.shape), mesh))


def compute_grads(params, model: Model, batch, grpo_cfg: GRPOConfig,
                  grad_accum: int = 1, ctx=None):
    """Grads of grpo_loss (a tree like ``params``, in its dtypes) and the
    metrics. With ``grad_accum`` > 1 the batch is split into that many
    equal microbatches along the batch axis (``ValueError`` unless
    ``grad_accum`` divides it); their grads accumulate in f32 and are
    averaged, and so are the metrics. Over a mesh with data rows each
    microbatch splits over them (local microbatches of ``B / rows /
    grad_accum``), and the grads come back in ZeRO-2's layout
    (``optimizer.state_partition_specs``): each device holds its
    ``data`` block of the sum over the rows and replicas."""
    if grad_accum <= 1:
        grads, metrics = value_and_grad(
            lambda p: grpo_loss(p, model, batch, grpo_cfg, ctx), params)
        return common.canonical_unflatten(params, grads), metrics
    n = next(iter(batch.values())).shape[0]
    if n % grad_accum:
        # the reference's reshape to (grad_accum, B // grad_accum, ...)
        # refuses this batch too
        raise ValueError(f"grad_accum {grad_accum} does not divide the "
                         f"batch of {n}")
    micro = {k: v.chunk(grad_accum) for k, v in batch.items()}
    acc, metrics = None, []
    for i in range(grad_accum):
        mb = {k: v[i] for k, v in micro.items()}
        grads, m = value_and_grad(
            lambda p: grpo_loss(p, model, mb, grpo_cfg, ctx), params)
        if acc is None:
            acc = {k: shd.leafwise(lambda t: t.float(), g)
                   for k, g in grads.items()}
        else:
            for k, g in grads.items():
                acc[k] = shd.leafwise(lambda a, t: a.add_(t.float()),
                                      acc[k], g)
        metrics.append(m)
    flat = common.canonical_flat(params)
    grads = {k: shd.leafwise(lambda a: (a / grad_accum).to(p.dtype), acc[k])
             for k, p in flat.items()}
    return (common.canonical_unflatten(params, grads),
            {k: torch.stack([m[k] for m in metrics]).mean()
             for k in metrics[0]})


def make_update_actor(model: Model, grpo: GRPOConfig = GRPOConfig(),
                      adamw: opt.AdamWConfig = opt.AdamWConfig(),
                      grad_accum: int = 1):
    """``update_actor`` primitive: forward, backward and AdamW.
    (state, batch, ctx=None) -> (state, metrics); the new parameters and
    moments are written into ``state``'s tensors (``optimizer.update_``)."""

    def step(state: TrainState, batch, ctx=None):
        grads, metrics = compute_grads(state.params, model, batch, grpo,
                                       grad_accum, ctx)
        opt_metrics = opt.update_(grads, state.opt_state, state.params,
                                  adamw)
        del grads
        metrics = dict(metrics, **opt_metrics)
        return TrainState(state.params, state.opt_state,
                          shd.leafwise(lambda t: t + 1, state.step)), metrics

    return step


def make_compute_log_prob(model: Model):
    """``compute_log_prob`` primitive (paper Tab. 2): forward-only
    logprobs."""

    def step(params, batch, ctx=None):
        logits, _ = model.forward(params, batch, ctx=ctx)[:2]
        return token_logprobs(logits, batch["tokens"])

    return step


def make_prefill(model: Model):
    """The serving prefill (``repro/rl/grpo.py:139``): (params, batch) ->
    (the last position's logits (B, 1, V), the cache); over data rows,
    a list of each row's (``layers.row_logits`` joins them)."""

    def step(params, batch, ctx=None):
        logits, _, cache = model.forward(params, batch, return_cache=True,
                                         ctx=ctx)
        if isinstance(logits, list):    # over data rows, a row's each
            return [t[:, -1:] for t in logits], cache
        return logits[:, -1:], cache

    return step


def make_decode(model: Model):
    """One decode step (``repro/rl/grpo.py:148``): (params, cache, batch)
    -> (logits (B, 1, V), the cache with ``pos`` + 1), the cache written
    in place."""

    def step(params, cache, batch, ctx=None):
        return model.decode_step(params, cache, batch, ctx=ctx)

    return step
