"""Wrappers the model calls: plain version on the CPU, kernel on the card.

A tensor on the CPU goes to :mod:`repro_torch.kernels.ref`; a CUDA tensor
goes to the hand-written kernel, or the launcher raises (there is no
fallback). Each wrapper counts its kernel launches in :data:`LAUNCHES`, so
a run can show that its path went through the kernels.

:func:`flash_attention` is a ``torch.autograd.Function`` on both devices:
its forward is K1 (or the plain version on the CPU), its backward
recomputes :func:`repro_torch.kernels.flash_attention.xla_attention` and
differentiates it, as the JAX package differentiates its XLA attention.
K3 has no backward: :func:`ssd` refuses a CUDA input that needs a
gradient rather than hand autograd an output without one.
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
                     scale: Optional[float] = None):
    """q: (B,H,D); caches (B,T,K,D); attends slots 0..pos (host int)."""
    if q.device.type == "cpu":
        return ref.ref_decode_attention(q, k_cache, v_cache, pos, scale=scale)
    out = dec.decode_attention(q, k_cache, v_cache, pos, scale=scale)
    _count("decode_attention")
    return out


def ssd(x, dt, A, B, C, *, chunk: int = 256):
    """SSD chunk scan, ngroups == 1. x: (b, s, h, p); dt: (b, s, h) f32;
    A: (h,) f32; B, C: (b, s, 1, n). Returns (y, final state (b, h, p, n)
    f32). The chunk is ``min(chunk, s)``, as ``repro.kernels.ops.ssd``."""
    chunk = min(chunk, x.shape[1])
    if x.device.type == "cpu":
        return ref.ref_ssd(x, dt, A, B, C, chunk=chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        raise NotImplementedError(
            "K3 has no backward: training mamba2 on the card is not ported "
            "yet (ROADMAP.md, Queue 1: mamba2 training)")
    out = ssd_k.ssd_chunk_scan(x, dt, A, B, C, chunk=chunk)
    _count("ssd")
    return out
