"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA Hopper card and nvcc: it is marked
``cuda`` and skips elsewhere. It imports no JAX, so it runs on the machine
with the card:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: f32 2e-3, bf16 5e-2 (the kernel keeps probabilities in f32
where the plain version rounds them to bf16 before the PV product).
"""
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=2e-3, atol=2e-3),
       torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kh,d,causal,window,softcap,scale", [
    (1, 128, 128, 4, 4, 64, True, 0, None, None),      # MHA
    (2, 256, 256, 8, 2, 64, True, 0, None, None),      # GQA 4:1
    (1, 192, 192, 4, 1, 128, True, 0, None, None),     # MQA, D = 128
    (16, 128, 128, 14, 2, 64, True, 0, None, None),    # qwen2 prefill, g = 7
    (2, 200, 200, 14, 2, 64, True, 0, None, None),     # ragged S
    (2, 128, 128, 14, 2, 64, True, 64, None, None),    # window
    (2, 128, 128, 14, 2, 64, True, 0, 50.0, 0.125),    # softcap + scale
    (2, 77, 131, 14, 2, 64, False, 0, None, None),     # non-causal, ragged T
])
def test_flash_attention_kernel_matches_plain(dev, b, s, t, h, kh, d, causal,
                                              window, softcap, scale, dtype):
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _randn(gen, (b, s, h, d), dtype, dev)
    k = _randn(gen, (b, t, kh, d), dtype, dev)
    v = _randn(gen, (b, t, kh, d), dtype, dev)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    g = h // kh
    expect = ref.ref_attention(q, k.repeat_interleave(g, 2),
                               v.repeat_interleave(g, 2), **kw)
    torch.testing.assert_close(out.float(), expect.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,kh,d,pos", [
    (2, 256, 8, 2, 64, 0), (2, 256, 8, 2, 64, 63), (2, 256, 8, 2, 64, 100),
    (2, 256, 8, 2, 64, 255), (2, 256, 8, 1, 128, 200),
    (16, 192, 14, 2, 64, 0), (16, 192, 14, 2, 64, 127),
    (16, 192, 14, 2, 64, 191),                          # qwen2 decode, g = 7
])
def test_decode_attention_kernel_matches_plain(dev, b, t, h, kh, d, pos,
                                               dtype):
    gen = torch.Generator(device=dev).manual_seed(1)
    q = _randn(gen, (b, h, d), dtype, dev)
    kc = _randn(gen, (b, t, kh, d), dtype, dev)
    vc = _randn(gen, (b, t, kh, d), dtype, dev)
    before = ops.LAUNCHES["decode_attention"]
    out = ops.decode_attention(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    torch.testing.assert_close(out.float(),
                               ref.ref_decode_attention(q, kc, vc, pos).float(),
                               **TOL[dtype])


def test_launch_errors_raise(dev):
    q = torch.randn(1, 4, 8, 32, device=dev)           # D = 32: no kernel
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, 0], q, q, 1)
