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

A ``meta`` tensor takes a third route: the wrapper returns outputs of the
kernel's shapes, dtypes and (contiguous) layout and computes nothing. It
is abstract evaluation for the cost model (``launch/hlo_cost.py``,
``launch/dryrun.py``), the counterpart of the reference's
``jit(...).lower``, and never a path for a real tensor. The plain route's
outputs are made contiguous too, so the ops after a wrapper are the same
on every device.

:func:`flash_attention_work`, :func:`decode_attention_work` and
:func:`ssd_work` give each kernel's work (FLOPs, bytes) from its shapes
and options: the bound column of ``chip_smoke.py`` and the cost model's
kernel terms. Each wrapper call reports its work to the active counters
(:data:`COUNTERS`), which leave out the ops that carry the call out; the
collectives of ``models/sharding.py`` report theirs the same way
(:func:`collective`). :func:`decode_attention` can also return each
row's log-sum-exp (K2's ``return_lse``), which a context-parallel decode
combines across the blocks of a cache.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
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


# the cost model's active counters (``launch/hlo_cost.Counter``): each
# wrapper call hands them its kernel's name and work, and they count none
# of the ops inside the call. A list shared by all threads, since autograd
# runs a rematerialised forward, and its K1 and K3 calls, on its own
# device thread.
COUNTERS: List = []


_UNCOUNTED = contextlib.nullcontext()


def _kernel_call(name: str, work, *shape, **opts):
    """The context of one wrapper call: with a counter active, it hands
    each its kernel's name and ``work(*shape, **opts)``; without one it
    costs nothing more (the work is not even computed: the wrappers' host
    time is part of ``chip_smoke.py``'s ``ms``)."""
    if not COUNTERS:
        return _UNCOUNTED
    return _counted(list(COUNTERS), name, work(*shape, **opts))


@contextlib.contextmanager
def _counted(counters, name: str, work: Tuple[int, int]):
    for c in counters:
        c.kernel_begin(name, *work)
    try:
        yield
    finally:
        for c in counters:
            c.kernel_end()


# the collectives the cost counters record (``models/sharding.py``), by
# the reference's names (``repro/launch/hlo_cost.py``)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


def collective(kind: str, nbytes: int, receivers: int):
    """The context of one collective of ``models/sharding.py``: with a
    counter active, each records ``receivers`` positions receiving a
    result of ``nbytes`` (the reference's convention: the result-shape
    bytes a device receives), and counts none of the copies and sums that
    carry it out; without one it costs nothing."""
    if not COUNTERS:
        return _UNCOUNTED
    return _collected(list(COUNTERS), kind, nbytes, receivers)


@contextlib.contextmanager
def _collected(counters, kind: str, nbytes: int, receivers: int):
    for c in counters:
        c.collective_begin(kind, nbytes, receivers)
    try:
        yield
    finally:
        for c in counters:
            c.kernel_end()


# ------------------------------------------------------------------ work

def _attended_keys(s: int, t: int, causal: bool, window: int,
                   q_off: int = 0) -> int:
    """Query-key pairs a prefill attends: row i (position p = q_off + i)
    sees key j (position j < t) where j <= p when causal and p - window <
    j when ``window`` > 0, as ``ref.ref_attention`` masks them."""
    i = q_off + np.arange(s, dtype=np.int64)
    hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(s, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_attention_work(b: int, s: int, t: int, h: int, kh: int, d: int,
                         itemsize: int, *, causal: bool = True,
                         window: int = 0, q_off: int = 0) -> Tuple[int, int]:
    """K1's (FLOPs, bytes): QK^T and PV over the pairs the masks keep (a
    causal row's keys up to its own, those in the window), 2 FLOPs a
    multiply-add; q read and the output written once, and the K and V
    rows read once: all T of them, but for a query offset (a multi-token
    cache write) whose window starts past key 0, from the window's first
    key on."""
    flops = 4 * b * h * d * _attended_keys(s, t, causal, window, q_off)
    first = max(0, q_off - window + 1) if window else 0
    return flops, (2 * b * s * h * d + 2 * b * (t - first) * kh * d) \
        * itemsize


def decode_attention_work(b: int, h: int, kh: int, d: int, pos: int,
                          itemsize: int, cache_itemsize: int, *,
                          window: int = 0, lse: bool = False
                          ) -> Tuple[int, int]:
    """K2's (FLOPs, bytes): one query row over the live keys (0..pos, the
    last ``window`` of them; none where ``pos`` < 0); q read and the
    output written once, the live K and V cache rows read once, and with
    ``lse`` each row's f32 log-sum-exp written."""
    live = max(0, min(pos + 1, window or pos + 1))
    return (4 * b * h * d * live,
            2 * b * h * d * itemsize + 2 * b * live * kh * d * cache_itemsize
            + (4 * b * h if lse else 0))


def ssd_flops(b: int, s: int, h: int, p: int, n: int, chunk: int) -> int:
    """Operations of the chunk scan, counting each chunk's causal half of
    the scores: C.B and the scores times x over the pairs j <= i, the
    carried state's C S, and the state update."""
    total = 0
    for t0 in range(0, s, chunk):
        lc = min(chunk, s - t0)
        pairs = lc * (lc + 1) // 2
        total += 2 * pairs * (n + p) + 2 * 2 * lc * n * p
    return b * h * total


def ssd_work(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
             x_itemsize: int, bc_itemsize: int) -> Tuple[int, int]:
    """K3's (FLOPs, bytes): :func:`ssd_flops`; x, dt (f32), B, C and A
    (f32) read once, y and the f32 final state written once."""
    nbytes = (2 * b * s * h * p * x_itemsize + b * s * h * 4
              + 2 * b * s * g * n * bc_itemsize + h * 4 + b * h * p * n * 4)
    return ssd_flops(b, s, h, p, n, chunk), nbytes


class _FlashAttention(torch.autograd.Function):
    """K1 forward; backward through the XLA attention's autograd."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_chunk,
                q_off):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        ctx.q_chunk = q_chunk
        ctx.q_off = q_off
        b, s, h, d = q.shape
        with _kernel_call("flash_attention", flash_attention_work, b, s,
                          k.shape[1], h, k.shape[2], d, q.element_size(),
                          causal=causal, window=window, q_off=q_off):
            if q.device.type == "meta":
                return torch.empty(q.shape, dtype=q.dtype, device="meta")
            if q.device.type == "cpu":
                g = h // k.shape[2]
                return ref.ref_attention(
                    q, torch.repeat_interleave(k, g, dim=2),
                    torch.repeat_interleave(v, g, dim=2), q_off=q_off,
                    **ctx.opts).contiguous()
            out = fa.flash_attention_fwd(q, k, v, q_off=q_off, **ctx.opts)
            _count("flash_attention")
            return out

    @staticmethod
    def backward(ctx, dout):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        s = leaves[0].shape[1]
        positions = None if not ctx.q_off else (
            ctx.q_off + torch.arange(s, device=dout.device))[None]
        with torch.enable_grad():
            out = fa.xla_attention(*leaves, **ctx.opts, q_chunk=ctx.q_chunk,
                                   q_positions=positions)
        grads = torch.autograd.grad(out, leaves, dout)
        return (*grads, None, None, None, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None, q_chunk: int = 256,
                    q_off: int = 0):
    """q: (B,S,H,D); k,v: (B,T,K,D) with K | H; query row i at position
    ``q_off + i`` (a multi-token cache write passes the first ``q_off + S``
    rows of its cache as k and v). Returns (B,S,H,D), differentiable in
    q, k and v; the backward recomputes the XLA attention in blocks of
    ``q_chunk`` query rows."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                 q_chunk, q_off)


def decode_attention(q, k_cache, v_cache, pos: int, *,
                     scale: Optional[float] = None, window: int = 0,
                     softcap: Optional[float] = None,
                     return_lse: bool = False):
    """q: (B,H,D); caches (B,T,K,D); attends slots 0..pos (host int), the
    last ``window`` of them when ``window`` > 0, with the scores capped at
    ``softcap`` (None: no cap). With ``return_lse``, ``(out, lse)``: each
    row's f32 log-sum-exp (B, H), -inf where no slot is live (``pos`` <
    0), the context-parallel decode's combine weight."""
    opts = dict(scale=scale, window=window, softcap=softcap)
    b, h, d = q.shape
    with _kernel_call("decode_attention", decode_attention_work, b, h,
                      k_cache.shape[2], d, pos, q.element_size(),
                      k_cache.element_size(), window=window,
                      lse=return_lse):
        if q.device.type == "meta":
            out = torch.empty(q.shape, dtype=q.dtype, device="meta")
            return (out, torch.empty((b, h), dtype=torch.float32,
                                     device="meta")) if return_lse else out
        if q.device.type == "cpu":
            got = ref.ref_decode_attention(q, k_cache, v_cache, pos,
                                           return_lse=return_lse, **opts)
            if return_lse:
                return got[0].contiguous(), got[1].contiguous()
            return got.contiguous()
        out = dec.decode_attention(q, k_cache, v_cache, pos,
                                   return_lse=return_lse, **opts)
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
        b, s, h, p = x.shape
        g, n = B.shape[2], B.shape[3]
        with _kernel_call("ssd", ssd_work, b, s, h, p, g, n, chunk,
                          x.element_size(), B.element_size()):
            if x.device.type == "meta":
                return (torch.empty(x.shape, dtype=x.dtype, device="meta"),
                        torch.empty((b, h, p, n), dtype=torch.float32,
                                    device="meta"))
            if x.device.type == "cpu":
                y, state = ref.ref_ssd(x, dt, A, B, C, chunk=chunk)
                return y.contiguous(), state.contiguous()
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
