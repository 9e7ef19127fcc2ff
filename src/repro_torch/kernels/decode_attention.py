"""K2: single-token decode attention on Hopper (``csrc/decode_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention``). ``pos`` is a host integer passed as a kernel
argument (the TPU kernel's scalar prefetch), and the kernel stops at
``pos`` instead of masking a padded cache. bf16 inputs take the split-KV
route: :func:`splits_for` cuts the key axis into slices, one block each,
whose partial softmax results are combined on the chip inside one
thread-block cluster. f32 inputs take the first CUDA-core kernel. Only
CUDA tensors are accepted;
:func:`repro_torch.kernels.ops.decode_attention` is the wrapper that
sends CPU tensors to the plain version.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
MAX_GROUP = 16          # query heads per KV head
MAX_SPLITS = 16         # blocks a cluster: the H100's non-portable limit
CHUNK = 16              # keys a warp takes at a time


def splits_for(b: int, kh: int, t: int, sms: int) -> int:
    """Splits of the key axis for each (sequence, KV head) of the bf16
    route: doubled from 1 while the grid ``b * kh * splits`` is short of the
    card's ``sms``, up to one cluster of :data:`MAX_SPLITS`, as long as each
    split keeps a whole :data:`CHUNK` of keys. It reads the cache capacity
    ``t`` and never the decode position, so the launch is the same at
    every step."""
    s = 1
    while (s < MAX_SPLITS and b * kh * s < sms
           and -(-t // (2 * s)) >= CHUNK):
        s *= 2
    return s


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q, k_cache, v_cache, pos: int, *,
                     scale: Optional[float] = None):
    """q: (B, H, D) one new token's queries; k/v_cache: (B, T, K, D);
    attends cache slots 0..pos. Returns (B, H, D)."""
    b, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    if not (q.is_cuda and k_cache.device == q.device
            and v_cache.device == q.device):
        raise ValueError("decode_attention needs q and caches on one CUDA "
                         "device")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"decode_attention takes f32 or bf16, got "
                         f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if d not in HEAD_DIMS or k_cache.shape != (b, t, kh, d) \
            or v_cache.shape != k_cache.shape or h % kh \
            or h // kh > MAX_GROUP:
        raise ValueError(f"decode_attention shapes q {tuple(q.shape)} "
                         f"cache {tuple(k_cache.shape)}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention needs contiguous caches")
    q = q.contiguous()
    splits = 1
    if q.dtype == torch.bfloat16:
        # the split route copies 16-byte rows
        if any(x.data_ptr() % 16 for x in (q, k_cache, v_cache)):
            raise ValueError("decode_attention's bf16 route needs q and "
                             "caches 16-byte aligned")
        splits = splits_for(b, kh, t, _sm_count(q.device.index))
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    lib = build.load()
    with torch.cuda.device(q.device):
        err = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), b, t, h, kh, d, _DTYPES[q.dtype], int(pos),
            float(scale), splits,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "decode_attention")
    return out
