"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA Hopper card and nvcc: it is marked
``cuda`` and skips elsewhere. It imports no JAX, so it runs on the machine
with the card:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: f32 2e-3, bf16 5e-2 (bf16 keeps 8 significant bits; the
bf16 route rounds the unnormalised probabilities to bf16 before the PV
product where the plain version rounds the normalised ones). Each kernel
has two routes, chosen by dtype: bf16 on the tensor cores (K2's split
across the key axis and combined in a thread-block cluster), f32 on the
CUDA cores; both are tested here. K3
(SSD chunk scan) as tests/test_kernels.py holds the TPU kernel: y at 2e-3
in f32 and 2e-2 in bf16 (one rounding of y on both sides), the f32 final
state at 1e-2 in bf16 and 2e-3 in f32.
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as tdec
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
    (2, 200, 200, 32, 32, 112, True, 0, None, None),   # zamba2: MHA, D = 112
    (2, 128, 128, 8, 2, 112, True, 64, None, None),    # D = 112, GQA, window
    (16, 512, 512, 32, 32, 112, True, 0, None, None),  # zamba2 prefill
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
    (2, 256, 8, 2, 112, 100), (16, 576, 32, 32, 112, 0),
    (16, 576, 32, 32, 112, 575),                        # zamba2 decode, g = 1
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 112, 128])
@pytest.mark.parametrize("g", [1, 4, 7, 8, 16])
def test_decode_attention_at_split_edges(dev, g, d, dtype):
    """pos at 0 (every split but the first empty), on the last key of a
    split, on the first key of the next and at T - 1; T = 200 is divided by
    no split count. One launch per call, whatever the splits."""
    b, kh, t = 2, 2, 200
    gen = torch.Generator(device=dev).manual_seed(2)
    q = _randn(gen, (b, g * kh, d), dtype, dev)
    kc = _randn(gen, (b, t, kh, d), dtype, dev)
    vc = _randn(gen, (b, t, kh, d), dtype, dev)
    splits = tdec.splits_for(b, kh, t, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    span = -(-t // splits)
    for pos in (0, span - 1, span, t - 1):
        before = ops.LAUNCHES["decode_attention"]
        out = ops.decode_attention(q, kc, vc, pos)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["decode_attention"] == before + 1
        assert torch.isfinite(out.float()).all(), pos
        torch.testing.assert_close(
            out.float(), ref.ref_decode_attention(q, kc, vc, pos).float(),
            **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 112, 128])
@pytest.mark.parametrize("t", [4096, 8192])
def test_decode_attention_long_cache_single_sequence(dev, t, d, dtype):
    """The long-tail straggler: B = 1 over a long cache, 16 splits of the
    bf16 route in one cluster. q is drawn at 3x unit scale so the softmax
    is sharp and the outputs are O(1): at unit scale they shrink as
    sqrt(e / T), below the tolerance, and a lost split would pass."""
    gen = torch.Generator(device=dev).manual_seed(3)
    q = (3 * torch.randn((1, 14, d), generator=gen, device=dev)).to(dtype)
    kc = _randn(gen, (1, t, 2, d), dtype, dev)
    vc = _randn(gen, (1, t, 2, d), dtype, dev)
    for pos in (t - 1, t // 2 + 3):
        out = ops.decode_attention(q, kc, vc, pos)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            out.float(), ref.ref_decode_attention(q, kc, vc, pos).float(),
            **TOL[dtype])


@pytest.mark.parametrize("s", [1, 15, 17, 63, 65, 200])
@pytest.mark.parametrize("d", [64, 112, 128])
@pytest.mark.parametrize("h,kh,window,softcap", [
    (4, 4, 0, None),           # g = 1
    (8, 2, 16, None),          # g = 4, window
    (14, 2, 0, 30.0),          # g = 7, softcap
])
def test_flash_attention_tensor_core_route_at_tile_edges(dev, s, d, h, kh,
                                                         window, softcap):
    """The bf16 route at lengths on either side of its 16-row warp and
    64-key tile edges."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q = _randn(gen, (2, s, h, d), torch.bfloat16, dev)
    k = _randn(gen, (2, s, kh, d), torch.bfloat16, dev)
    v = _randn(gen, (2, s, kh, d), torch.bfloat16, dev)
    kw = dict(causal=True, window=window, softcap=softcap)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    g = h // kh
    expect = ref.ref_attention(q, k.repeat_interleave(g, 2),
                               v.repeat_interleave(g, 2), **kw)
    torch.testing.assert_close(out.float(), expect.float(),
                               **TOL[torch.bfloat16])


def test_launch_errors_raise(dev):
    q = torch.randn(1, 4, 8, 32, device=dev)           # D = 32: no kernel
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, 0], q, q, 1)


SSD_TOL = {torch.float32: (dict(rtol=2e-3, atol=2e-3),
                           dict(rtol=2e-3, atol=2e-3)),
           torch.bfloat16: (dict(rtol=2e-2, atol=2e-2),
                            dict(rtol=1e-2, atol=1e-2))}


def _ssd_inputs(gen, b, s, h, p, n, dtype, bc_dtype, dev):
    x = _randn(gen, (b, s, h, p), dtype, dev)
    dt = torch.nn.functional.softplus(_randn(gen, (b, s, h), torch.float32,
                                             dev))
    A = -torch.exp(_randn(gen, (h,), torch.float32, dev))
    B = _randn(gen, (b, s, 1, n), bc_dtype, dev)
    C = _randn(gen, (b, s, 1, n), bc_dtype, dev)
    return x, dt, A, B, C


def _check_ssd(x, dt, A, B, C, chunk, dtype):
    before = ops.LAUNCHES["ssd"]
    y, st = ops.ssd(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd"] == before + 1
    ye, ste = ref.ref_ssd(x, dt, A, B, C, chunk=min(chunk, x.shape[1]))
    assert y.dtype == x.dtype and st.dtype == torch.float32
    ytol, stol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), ye.float(), **ytol)
    torch.testing.assert_close(st, ste, **stol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 512, 4, 64, 128, 256),        # whole chunks
    (2, 300, 4, 64, 128, 256),        # ragged last chunk
    (2, 100, 4, 64, 128, 256),        # shorter than one chunk
    (1, 72, 2, 8, 16, 24),            # p = 8, n = 16
    (2, 96, 3, 8, 128, 32),
    (2, 40, 3, 64, 16, 16),
    (16, 512, 80, 64, 128, 256),      # mamba2-2.7b prefill
    (16, 512, 112, 64, 64, 256),      # zamba2-7b prefill
])
def test_ssd_kernel_matches_plain(dev, b, s, h, p, n, chunk, dtype):
    gen = torch.Generator(device=dev).manual_seed(2)
    _check_ssd(*_ssd_inputs(gen, b, s, h, p, n, dtype, dtype, dev), chunk,
               dtype)


def test_ssd_kernel_reads_model_views_and_mixed_dtypes(dev):
    """x, B, C as the model passes them (views into one conv output), and
    bf16 x with f32 B, C as tests/test_kernels.py feeds the TPU kernel."""
    gen = torch.Generator(device=dev).manual_seed(3)
    b, s, h, p, n = 2, 300, 4, 64, 128
    xbc = _randn(gen, (b, s, h * p + 2 * n), torch.bfloat16, dev)
    _, dt, A, _, _ = _ssd_inputs(gen, b, s, h, p, n, torch.bfloat16,
                                 torch.bfloat16, dev)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    B = xbc[..., h * p:h * p + n].reshape(b, s, 1, n)
    C = xbc[..., h * p + n:].reshape(b, s, 1, n)
    assert not x.is_contiguous()
    _check_ssd(x, dt, A, B, C, 256, torch.bfloat16)
    _check_ssd(x, dt, A, B.float(), C.float(), 256, torch.bfloat16)


def test_ssd_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    x, dt, A, B, C = _ssd_inputs(gen, 1, 64, 2, 64, 128, torch.bfloat16,
                                 torch.bfloat16, dev)
    from repro_torch.kernels import ssd as ssd_k
    with pytest.raises(ValueError, match="f32"):          # dt in bf16
        ops.ssd(x, dt.bfloat16(), A, B, C)
    with pytest.raises(ValueError, match="f32"):          # fp16 x
        ops.ssd(x.half(), dt, A, B, C)
    with pytest.raises(ValueError, match="CUDA"):         # A on the CPU
        ops.ssd(x, dt, A.cpu(), B, C)
    with pytest.raises(ValueError, match="shapes"):       # ngroups = 2
        ops.ssd(x, dt, A, B.repeat(1, 1, 2, 1), C.repeat(1, 1, 2, 1))
    with pytest.raises(ValueError, match="shapes"):       # p not a multiple of 4
        ops.ssd(x[..., :62], dt, A, B, C)
    with pytest.raises(ValueError, match="shapes"):       # chunk > 256
        ssd_k.ssd_chunk_scan(x, dt, A, B, C, chunk=512)


@pytest.mark.parametrize("lc", [1, 15, 17, 44, 100, 256])
def test_ssd_tensor_core_route_at_chunk_lengths(dev, lc):
    """A whole chunk, then a last chunk of ``lc`` tokens, at P = N = 128
    (the 8-warp instantiation)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    _check_ssd(*_ssd_inputs(gen, 2, 256 + lc, 3, 128, 128, torch.bfloat16,
                            torch.bfloat16, dev), 256, torch.bfloat16)


@pytest.mark.parametrize("p,n", [(64, 128), (128, 128)])
def test_ssd_tensor_core_route_reads_model_views(dev, p, n):
    """x, B, C as strided views of one conv output, at the mamba2 widths and
    at P = N = 128, with a ragged last chunk."""
    gen = torch.Generator(device=dev).manual_seed(7)
    b, s, h = 2, 300, 4
    xbc = _randn(gen, (b, s, h * p + 2 * n), torch.bfloat16, dev)
    _, dt, A, _, _ = _ssd_inputs(gen, b, s, h, p, n, torch.bfloat16,
                                 torch.bfloat16, dev)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    B = xbc[..., h * p:h * p + n].reshape(b, s, 1, n)
    C = xbc[..., h * p + n:].reshape(b, s, 1, n)
    _check_ssd(x, dt, A, B, C, 256, torch.bfloat16)
    # a view whose rows are not 16-byte aligned is copied, not refused
    odd = _randn(gen, (b, s, h * p + 2 * n + 1), torch.bfloat16, dev)[..., 1:]
    _check_ssd(odd[..., :h * p].reshape(b, s, h, p), dt, A,
               odd[..., h * p:h * p + n].reshape(b, s, 1, n),
               odd[..., h * p + n:].reshape(b, s, 1, n), 256, torch.bfloat16)


def test_f32_inputs_take_the_cuda_core_route(dev):
    """f32 inputs go to the CUDA-core kernels and hold 2e-3: at the serving
    shapes, and for K3 at P = 4, N = 12, widths only that route takes (bf16
    at those widths is refused)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    q = _randn(gen, (16, 128, 14, 64), torch.float32, dev)
    k = _randn(gen, (16, 128, 2, 64), torch.float32, dev)
    v = _randn(gen, (16, 128, 2, 64), torch.float32, dev)
    out = ops.flash_attention(q, k, v)
    expect = ref.ref_attention(q, k.repeat_interleave(7, 2),
                               v.repeat_interleave(7, 2))
    torch.testing.assert_close(out, expect, **TOL[torch.float32])
    _check_ssd(*_ssd_inputs(gen, 2, 300, 4, 64, 128, torch.float32,
                            torch.float32, dev), 256, torch.float32)
    args = _ssd_inputs(gen, 2, 100, 3, 4, 12, torch.float32, torch.float32,
                       dev)
    _check_ssd(*args, 32, torch.float32)
    x, dt, A, B, C = args
    with pytest.raises(ValueError, match="shapes"):
        ops.ssd(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16())


@pytest.mark.parametrize("b,s,h,kh", [
    (16, 128, 14, 2),                                  # the training shape
    (2, 200, 14, 2),                                   # g = 7, ragged S
])
def test_flash_attention_function_grads_match_xla_attention(dev, b, s, h,
                                                            kh):
    """K1 under its autograd Function: the output (one K1 launch) and the
    q, k, v gradients against plain autograd through the XLA-branch
    attention, within 5e-2 * max|expect| (bf16)."""
    from repro_torch.kernels.flash_attention import xla_attention
    gen = torch.Generator(device=dev).manual_seed(9)
    q = _randn(gen, (b, s, h, 64), torch.bfloat16, dev)
    k = _randn(gen, (b, s, kh, 64), torch.bfloat16, dev)
    v = _randn(gen, (b, s, kh, 64), torch.bfloat16, dev)
    ct = _randn(gen, (b, s, h, 64), torch.bfloat16, dev)
    grads, outs = [], []
    for fn in (ops.flash_attention, xla_attention):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = ops.LAUNCHES["flash_attention"]
        out = fn(*leaves, causal=True)
        torch.cuda.synchronize()
        launched = ops.LAUNCHES["flash_attention"] - before
        assert launched == (1 if fn is ops.flash_attention else 0)
        assert out.grad_fn is not None
        out.backward(ct)
        outs.append(out.detach().float())
        grads.append([t.grad.float() for t in leaves])
    for got, want in [*zip(*grads), tuple(outs)]:
        bound = 5e-2 * want.abs().max().item()
        assert (got - want).abs().max().item() <= bound


def test_ssd_refuses_a_gradient_on_the_card(dev):
    """K3 has no backward: under grad, an input that needs one raises
    rather than hand autograd an output without a grad_fn; without grad
    (the serving path) it runs."""
    gen = torch.Generator(device=dev).manual_seed(10)
    x, dt, A, B, C = _ssd_inputs(gen, 1, 64, 2, 64, 128, torch.bfloat16,
                                 torch.bfloat16, dev)
    with pytest.raises(NotImplementedError, match="mamba2 training"):
        ops.ssd(x.requires_grad_(), dt, A, B, C)
    with torch.no_grad():
        y, _ = ops.ssd(x, dt, A, B, C)
    assert y.grad_fn is None
