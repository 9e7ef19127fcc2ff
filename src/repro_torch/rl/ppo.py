"""PPO objective (actor and value head): the paper's baseline algorithm
family, the port of ``repro.rl.ppo``.

PlexRL schedules PPO's extra model roles (critic, reference) as additional
WPG deployments; this module provides the losses so multi-role jobs can be
expressed against the service API.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models.registry import Model
from repro_torch.rl.grpo import token_logprobs


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.0
    gae_lambda: float = 0.95
    gamma: float = 1.0


def gae_advantages(rewards, values, mask, cfg: PPOConfig):
    """Generalized advantage estimation over token sequences.

    rewards/values/mask: (B, T). Rewards are typically terminal-only for
    RLVR (verifiable reward at the last response token). The reverse
    recurrence over T, as the reference's reversed ``lax.scan``.
    """
    b, t = rewards.shape
    v_next = torch.cat([values[:, 1:], values.new_zeros((b, 1))], dim=1)
    adv = torch.empty_like(rewards)
    carry = rewards.new_zeros((b,))
    for i in range(t - 1, -1, -1):
        m = mask[:, i]
        delta = rewards[:, i] + cfg.gamma * v_next[:, i] * m - values[:, i]
        carry = delta + cfg.gamma * cfg.gae_lambda * m * carry
        adv[:, i] = carry
    return adv


def ppo_loss(params, model: Model, batch: Dict[str, Any], cfg: PPOConfig,
             ctx=None):
    """batch: tokens, behavior_logprobs, advantages (B, S) token-level (or
    (B,) per sequence), loss_mask. Returns (loss, {"pg_loss"})."""
    logits, aux = model.forward(params, batch, ctx=ctx)[:2]
    logp = token_logprobs(logits, batch["tokens"])
    behave = batch["behavior_logprobs"][:, 1:]
    mask = batch["loss_mask"][:, 1:]
    adv = batch["advantages"][:, 1:] if batch["advantages"].dim() == 2 \
        else batch["advantages"][:, None]

    ratio = torch.exp(logp - behave)
    clipped = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps)
    denom = torch.clamp(mask.sum(), min=1.0)
    pg = -(torch.minimum(ratio * adv, clipped * adv) * mask).sum() / denom

    loss = pg + 0.01 * aux
    if cfg.entropy_coef:
        p = torch.softmax(logits[:, :-1].float(), -1)
        ent = -(p * torch.log(p + 1e-9)).sum(-1)
        loss = loss - cfg.entropy_coef * (ent * mask).sum() / denom
    return loss, {"pg_loss": pg}


def value_loss(values, targets, old_values, mask, cfg: PPOConfig):
    """Clipped value loss for a critic deployment."""
    v_clip = old_values + torch.clamp(values - old_values, -cfg.clip_eps,
                                      cfg.clip_eps)
    l1 = torch.square(values - targets)
    l2 = torch.square(v_clip - targets)
    denom = torch.clamp(mask.sum(), min=1.0)
    return cfg.value_coef * (torch.maximum(l1, l2) * mask).sum() / denom
