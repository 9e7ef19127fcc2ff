"""Plain PyTorch versions of the attention kernels (the allclose targets).

Same signatures and layouts as ``repro.kernels.ref``: q (B, S, H, D) with
k, v (B, T, H, D) pre-repeated for GQA; decode q (B, H, D) with caches
(B, T, K, D). Scores and softmax are f32; the probabilities are cast to
v's dtype before the PV product, as the JAX oracles do. The CPU path of
:mod:`repro_torch.kernels.ops` runs these; on a card nothing on the
serving path calls them (``chip_smoke.py`` does, to hold each kernel
against its plain version).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def ref_attention(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None):
    """Dense attention. q: (B,S,H,D); k,v: (B,T,H,D) (pre-repeated GQA)."""
    s, d = q.shape[1], q.shape[3]
    t = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)


def ref_decode_attention(q, k_cache, v_cache, pos: int, *,
                         scale: Optional[float] = None):
    """q: (B,H,D); caches (B,T,K,D); attend to positions <= pos."""
    h, d = q.shape[1], q.shape[2]
    t, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    k = torch.repeat_interleave(k_cache, g, dim=2)
    v = torch.repeat_interleave(v_cache, g, dim=2)
    scale = d ** -0.5 if scale is None else scale
    scores = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * scale
    mask = torch.arange(t, device=q.device)[None, None, :] <= pos
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bht,bthd->bhd", probs.to(v.dtype), v)
