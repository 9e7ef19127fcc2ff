"""K3: Mamba2 SSD chunk scan on Hopper (``csrc/ssd.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/ssd.py``
(``ssd_chunk_scan``) and the chunk padding of its wrapper: the CUDA kernel
masks a ragged last chunk by its true length. x, B and C are read through
their token stride, so the model's views into one conv output go in
without a copy. The route follows the dtypes alone: bf16 x, B and C (the
serving path) take the tensor-core kernel, which needs P and N multiples
of 8 and 16-byte aligned token rows (a view that is not aligned is
copied); any f32 x, B or C takes the CUDA-core kernel. Only CUDA tensors
are accepted;
:func:`repro_torch.kernels.ops.ssd` is the wrapper that sends CPU tensors
to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 256
MAX_WIDTH = 128          # head dim P and state N: multiples of 8 for bf16
                         # x, B and C (the tensor-core route), else of 4


def _token_rows(t, align: int = 1):
    """``t`` (b, s, *inner) with the inner dims packed and one stride
    between tokens: returns (t, token stride), copying only when the layout
    does not allow that. With ``align`` > 1 the data pointer and the token
    stride must also be multiples of ``align`` bytes."""
    want, step = [], 1
    for d in reversed(t.shape[2:]):
        want.insert(0, step)
        step *= d
    if list(t.stride()[2:]) != want or t.stride(1) < step \
            or t.stride(0) != t.shape[1] * t.stride(1) \
            or t.data_ptr() % align or (t.stride(1) * t.element_size()) % align:
        t = t.clone(memory_format=torch.contiguous_format)
    return t, t.stride(1)


def ssd_chunk_scan(x, dt, A, B, C, *, chunk: int):
    """x: (b, s, h, p); dt: (b, s, h) f32 post-softplus; A: (h,) f32
    negative; B, C: (b, s, 1, n) (ngroups = 1). Returns (y (b, s, h, p) in
    x's dtype, final state (b, h, p, n) f32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    devs = {t.device for t in (x, dt, A, B, C)}
    if not x.is_cuda or len(devs) != 1:
        raise ValueError("ssd_chunk_scan needs x, dt, A, B, C on one CUDA "
                         "device")
    if x.dtype not in _DTYPES or B.dtype not in _DTYPES \
            or C.dtype != B.dtype or dt.dtype != torch.float32 \
            or A.dtype != torch.float32:
        raise ValueError(f"ssd_chunk_scan takes x, B, C in f32 or bf16 and "
                         f"dt, A in f32, got x {x.dtype} B {B.dtype} "
                         f"C {C.dtype} dt {dt.dtype} A {A.dtype}")
    tensor_cores = x.dtype == B.dtype == torch.bfloat16
    width = 8 if tensor_cores else 4
    if dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, 1, n) \
            or C.shape != B.shape or p % width or n % width \
            or p > MAX_WIDTH or n > MAX_WIDTH or not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_chunk_scan shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} A {tuple(A.shape)} B "
                         f"{tuple(B.shape)} C {tuple(C.shape)} chunk {chunk}")
    align = 16 if tensor_cores else 1
    x, x_ts = _token_rows(x, align)
    B, b_ts = _token_rows(B.reshape(b, s, n), align)
    C, c_ts = _token_rows(C.reshape(b, s, n), align)
    dt, A = dt.contiguous(), A.contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.repro_ssd_chunk_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr(), b, s, h, p, n,
            int(chunk), x_ts, b_ts, c_ts, _DTYPES[x.dtype], _DTYPES[B.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ssd_chunk_scan")
    return y, state
