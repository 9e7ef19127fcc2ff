"""GRPO (group-relative policy optimization) objective and step builders.

The port of ``repro.rl.grpo``: the ``compute_log_prob`` (forward) and
``update_actor`` (forward, backward, AdamW) primitives PlexRL schedules
(paper Tab. 2). Parameters are the model's nested-dict trees. Gradients
come from ``torch.autograd.grad`` over detached copies of the leaves that
require grad, so the stored tensors never join a graph; attention's
gradient is the JAX package's XLA autodiff (``kernels/ops.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models import common
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


def grpo_loss(params, model: Model, batch: Dict[str, Any], cfg: GRPOConfig):
    """Clipped importance-sampling surrogate with group-relative advantages.

    batch: tokens (B,S), behavior_logprobs (B,S), advantages (B,),
    loss_mask (B,S); the mask selects response tokens.
    """
    logits, aux = model.forward(params, batch)[:2]
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


def _value_and_grad(params, model: Model, batch, cfg: GRPOConfig):
    """Flat {key: grad} of grpo_loss (zeros for an unused leaf, as
    ``jax.grad``) and the metrics with the loss."""
    leaves = {k: p.detach().requires_grad_()
              for k, p in common.canonical_flat(params).items()}
    loss, metrics = grpo_loss(common.canonical_unflatten(params, leaves),
                              model, batch, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), grads)}
    metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
    return grads, metrics


def compute_grads(params, model: Model, batch, grpo_cfg: GRPOConfig,
                  grad_accum: int = 1):
    """Grads of grpo_loss (a tree like ``params``, in its dtypes) and the
    metrics. With ``grad_accum`` > 1 the batch is split into that many
    equal microbatches along the batch axis (``ValueError`` unless
    ``grad_accum`` divides it); their grads accumulate in f32 and are
    averaged, and so are the metrics."""
    if grad_accum <= 1:
        grads, metrics = _value_and_grad(params, model, batch, grpo_cfg)
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
        grads, m = _value_and_grad(
            params, model, {k: v[i] for k, v in micro.items()}, grpo_cfg)
        if acc is None:
            acc = {k: g.float() for k, g in grads.items()}
        else:
            for k, g in grads.items():
                acc[k] += g.float()
        metrics.append(m)
    flat = common.canonical_flat(params)
    grads = {k: (acc[k] / grad_accum).to(p.dtype) for k, p in flat.items()}
    return (common.canonical_unflatten(params, grads),
            {k: torch.stack([m[k] for m in metrics]).mean()
             for k in metrics[0]})


def make_update_actor(model: Model, grpo: GRPOConfig = GRPOConfig(),
                      adamw: opt.AdamWConfig = opt.AdamWConfig(),
                      grad_accum: int = 1):
    """``update_actor`` primitive: forward, backward and AdamW.
    (state, batch) -> (state, metrics)."""

    def step(state: TrainState, batch):
        grads, metrics = compute_grads(state.params, model, batch, grpo,
                                       grad_accum)
        new_params, new_opt, opt_metrics = opt.update(
            grads, state.opt_state, state.params, adamw)
        metrics = dict(metrics, **opt_metrics)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return step


def make_compute_log_prob(model: Model):
    """``compute_log_prob`` primitive (paper Tab. 2): forward-only
    logprobs."""

    def step(params, batch):
        logits, _ = model.forward(params, batch)[:2]
        return token_logprobs(logits, batch["tokens"])

    return step
