"""K1: flash-attention forward on Hopper (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention_fwd``). The CUDA kernel indexes the KV head as
``h // (H // K)`` and masks the ragged S and T edges by their true lengths,
so this launcher neither repeats KV nor pads. The route follows the dtype
alone: bf16 q, k, v (the serving path) take the tensor-core kernel
(``mma.sync`` with P rounded to bf16 before the PV product, as the TPU
kernel rounds it); f32 takes the CUDA-core kernel. Only CUDA tensors are
accepted; :func:`repro_torch.kernels.ops.flash_attention` is the wrapper
that sends CPU tensors to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None):
    """q: (B, S, H, D); k, v: (B, T, K, D) with K | H. Returns (B, S, H, D)."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_fwd needs q, k, v on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_fwd takes f32 or bf16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS or k.shape != (b, t, kh, d) or v.shape != k.shape \
            or h % kh:
        raise ValueError(f"flash_attention_fwd shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be positive")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    lib = build.load()
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, kh, d, _DTYPES[q.dtype], float(scale), int(causal),
            int(window), float(softcap or 0.0),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_fwd")
    return out
