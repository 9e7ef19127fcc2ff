"""Wrappers the model calls: plain version on the CPU, kernel on the card.

A tensor on the CPU goes to :mod:`repro_torch.kernels.ref`; a CUDA tensor
goes to the hand-written kernel, or the launcher raises (there is no
fallback). Each wrapper counts its kernel launches in :data:`LAUNCHES`, so
a run can show that its path went through the kernels.

:func:`flash_attention` is a ``torch.autograd.Function`` on both devices:
its forward is K1 (or the plain version on the CPU), its backward
recomputes :func:`repro_torch.kernels.flash_attention.xla_attention` and
differentiates it, as the JAX package differentiates its XLA attention.
:func:`ssd` is one too: its forward is K3 (or ``ref_ssd`` on the CPU), its
backward recomputes :func:`repro_torch.models.mamba2.ssd_chunked` and
differentiates it, as the JAX package differentiates ``ssd_chunked``.
Neither kernel has a backward kernel: the JAX package has none either.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import ssd as ssd_k

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "decode_attention": 0,
                            "ssd": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


class _FlashAttention(torch.autograd.Function):
    """K1 forward; backward through the XLA attention's autograd."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_chunk):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        ctx.q_chunk = q_chunk
        if q.device.type == "cpu":
            g = q.shape[2] // k.shape[2]
            return ref.ref_attention(
                q, torch.repeat_interleave(k, g, dim=2),
                torch.repeat_interleave(v, g, dim=2), **ctx.opts)
        out = fa.flash_attention_fwd(q, k, v, **ctx.opts)
        _count("flash_attention")
        return out

    @staticmethod
    def backward(ctx, dout):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = fa.xla_attention(*leaves, **ctx.opts, q_chunk=ctx.q_chunk)
        grads = torch.autograd.grad(out, leaves, dout)
        return (*grads, None, None, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None, q_chunk: int = 256):
    """q: (B,S,H,D); k,v: (B,T,K,D) with K | H. Returns (B,S,H,D),
    differentiable in q, k and v; the backward recomputes the XLA
    attention in blocks of ``q_chunk`` query rows."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                 q_chunk)


def decode_attention(q, k_cache, v_cache, pos: int, *,
                     scale: Optional[float] = None, window: int = 0,
                     softcap: Optional[float] = None):
    """q: (B,H,D); caches (B,T,K,D); attends slots 0..pos (host int), the
    last ``window`` of them when ``window`` > 0, with the scores capped at
    ``softcap`` (None: no cap)."""
    opts = dict(scale=scale, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return ref.ref_decode_attention(q, k_cache, v_cache, pos, **opts)
    out = dec.decode_attention(q, k_cache, v_cache, pos, **opts)
    _count("decode_attention")
    return out


class _SSDScan(torch.autograd.Function):
    """K3 forward; backward through the autograd of ``ssd_chunked``.

    The forward keeps the intra-chunk scores in f32 (K3's function, and
    ``ref_ssd``'s); the backward differentiates the reference model's
    ``ssd_chunked``, which rounds them to x's dtype, so the gradient is
    the one ``jax.grad`` takes through the JAX model."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        # an unused final state (the training path drops it) comes back
        # as None, not as a (b, h, p, n) tensor of zeros
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            return ref.ref_ssd(x, dt, A, B, C, chunk=chunk)
        out = ssd_k.ssd_chunk_scan(x, dt, A, B, C, chunk=chunk)
        _count("ssd")
        return out

    @staticmethod
    def backward(ctx, dy, dstate):
        from repro_torch.models.mamba2 import ssd_chunked

        saved = ctx.saved_tensors
        want = [i for i, need in enumerate(ctx.needs_input_grad[:5]) if need]
        outs = [(0, dy), (1, dstate)]
        outs = [(i, ct) for i, ct in outs if ct is not None]
        grads = [None] * 5
        if want and outs:
            leaves = [t.detach().requires_grad_(i in want)
                      for i, t in enumerate(saved)]
            with torch.enable_grad():
                res = ssd_chunked(*leaves, ctx.chunk)
            got = torch.autograd.grad([res[i] for i, _ in outs],
                                      [leaves[i] for i in want],
                                      [ct for _, ct in outs],
                                      allow_unused=True)
            for i, g in zip(want, got):
                grads[i] = g
        return (*grads, None)


def ssd(x, dt, A, B, C, *, chunk: int = 256):
    """SSD chunk scan, ngroups == 1. x: (b, s, h, p); dt: (b, s, h) f32;
    A: (h,) f32; B, C: (b, s, 1, n). Returns (y, final state (b, h, p, n)
    f32), differentiable in x, dt, A, B and C. The chunk is
    ``min(chunk, s)``, as ``repro.kernels.ops.ssd``."""
    return _SSDScan.apply(x, dt, A, B, C, min(chunk, x.shape[1]))
