"""Plain PyTorch versions of the kernels (the allclose targets).

Same signatures and layouts as ``repro.kernels.ref``: q (B, S, H, D) with
k, v (B, T, H, D) pre-repeated for GQA; decode q (B, H, D) with caches
(B, T, K, D). Scores and softmax are f32; the probabilities are cast to
v's dtype before the PV product, as the JAX oracles do. The SSD chunk
scan keeps its whole y path in f32 and rounds y once, as K3 does. The CPU
path of :mod:`repro_torch.kernels.ops` runs these; on a card nothing on
the serving paths calls them (``chip_smoke.py`` does, to hold each kernel
against its plain version).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def ref_attention(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None, q_off: int = 0):
    """Dense attention. q: (B,S,H,D); k,v: (B,T,H,D) (pre-repeated GQA);
    query row i at position ``q_off + i``, key j at position j."""
    s, d = q.shape[1], q.shape[3]
    t = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = q_off + torch.arange(s, device=q.device)[:, None]
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
                         scale: Optional[float] = None, window: int = 0,
                         softcap: Optional[float] = None,
                         return_lse: bool = False):
    """q: (B,H,D); caches (B,T,K,D); attend to positions <= pos, and with
    ``window`` > 0 only to those with pos - window < key (the reference's
    ``kp > qp - window``, ``repro/models/layers.py:172-173``). ``softcap``
    caps the scaled scores as ``softcap * tanh(s / softcap)``. With
    ``return_lse``, also each row's f32 log-sum-exp of its live scaled
    (capped) scores, (B, H): -inf, and an output of zeros, where no key
    is live (``pos`` below 0: a block of a context-parallel cache that
    starts past the decode position)."""
    h, d = q.shape[1], q.shape[2]
    t, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    k = torch.repeat_interleave(k_cache, g, dim=2)
    v = torch.repeat_interleave(v_cache, g, dim=2)
    scale = d ** -0.5 if scale is None else scale
    scores = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    key = torch.arange(t, device=q.device)
    mask = key <= pos
    if window:
        mask &= key > pos - window
    if return_lse:
        live = torch.where(mask[None, None, :], scores,
                           torch.tensor(float("-inf"), device=q.device))
        lse = torch.logsumexp(live, dim=-1)
        if not bool(mask.any()):
            return torch.zeros_like(q), lse
    scores = torch.where(mask[None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bht,bthd->bhd", probs.to(v.dtype), v)
    return (out, lse) if return_lse else out


def ref_ssd(x, dt, A, B, C, *, chunk: int = 256):
    """Chunked SSD scan: what K3 computes.

    x: (b, s, h, p); dt: (b, s, h) post-softplus; A: (h,) negative; B, C:
    (b, s, g, n). Returns (y (b, s, h, p) in x's dtype, final state
    (b, h, p, n) f32). It is ``repro.models.mamba2.ssd_chunked`` with the
    intra-chunk scores kept in f32 (no downcast to x's dtype before the
    product with x), as in ``repro/kernels/ssd.py``. A ragged tail is
    padded with dt = 0: decay 1 and no state update.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = (-s) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, 0, 0, pad))
    nc = (s + pad) // chunk
    rep = h // g
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, g, n).float().repeat_interleave(rep, 3)
    Cc = C.reshape(b, nc, chunk, g, n).float().repeat_interleave(rep, 3)

    dA_cs = torch.cumsum(dtc * A.float(), dim=2)                 # (b,nc,l,h)
    # intra-chunk: L[i, j] = exp(cs_i - cs_j) for j <= i, else 0
    cs = dA_cs.transpose(-1, -2)                                  # (b,nc,h,l)
    seg = cs[..., :, None] - cs[..., None, :]
    tril = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=x.device).tril()
    L = torch.exp(torch.where(tril, seg, float("-inf")))
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    scores = scores * L * dtc.transpose(-1, -2)[:, :, :, None, :]
    y = torch.einsum("bchls,bcshp->bclhp", scores, xc)

    # chunk summary states, then the inter-chunk recurrence
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)        # (b,nc,l,h)
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", Bc,
                          decay_states * dtc, xc)                 # (b,nc,h,p,n)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                   # (b,nc,h)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    entry = []
    for c in range(nc):
        entry.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    entry = torch.stack(entry, 1)                                 # (b,nc,h,p,n)
    y = y + torch.einsum("bclhn,bchpn,bclh->bclhp", Cc, entry,
                         torch.exp(dA_cs))
    return y.reshape(b, nc * chunk, h, p)[:, :s].to(x.dtype), state


def ref_ssd_naive(x, dt, A, B, C):
    """Token-by-token recurrence through the model's ``ssd_decode``: the
    ground-truth semantics."""
    from repro_torch.models.mamba2 import ssd_decode
    b, s, h, p = x.shape
    state = torch.zeros((b, h, p, B.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        y, state = ssd_decode(state, x[:, t], dt[:, t], A, B[:, t], C[:, t])
        ys.append(y)
    return torch.stack(ys, 1), state
