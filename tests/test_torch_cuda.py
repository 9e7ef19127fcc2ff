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
    (16, 256, 256, 32, 4, 128, True, 0, None, None),   # Qwen3-30B-A3B, g = 8
    (16, 64, 64, 24, 8, 64, True, 0, None, None),      # granite generate
    (16, 128, 128, 24, 8, 64, True, 0, None, None),    # granite training
    (16, 128, 128, 20, 20, 64, True, 0, None, None),   # whisper decoder
    # gemma2-27b's prefill: GQA 32:16, D = 128, softcap 50, scale 1/12; the
    # local layers' window of 4096, and one that cuts
    (16, 128, 128, 32, 16, 128, True, 0, 50.0, 1 / 12),
    (16, 128, 128, 32, 16, 128, True, 4096, 50.0, 1 / 12),
    (1, 600, 600, 32, 16, 128, True, 256, 50.0, 1 / 12),
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
    (16, 320, 32, 4, 128, 256),
    (16, 320, 32, 4, 128, 319),                         # Qwen3 MoE, g = 8
    (16, 128, 24, 8, 64, 64),
    (16, 128, 24, 8, 64, 127),                          # granite, g = 3
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
@pytest.mark.parametrize("b,t,h,kh,d,pos", [
    (1, 4096, 16, 16, 112, 4095), (1, 4096, 16, 16, 112, 1903),
    (1, 4096, 16, 16, 112, -1),       # a block past the position
    (8, 192, 7, 1, 64, 191), (2, 256, 8, 2, 64, 0),
])
def test_decode_attention_lse_matches_plain(dev, b, t, h, kh, d, pos, dtype):
    """K2's log-sum-exp output (the context-parallel decode's combine
    weight) against the plain version's: the output within the dtype's
    tolerance, the f32 lse within 1e-2; -inf and zeros where no key is
    live."""
    gen = torch.Generator(device=dev).manual_seed(2)
    q = _randn(gen, (b, h, d), dtype, dev)
    kc = _randn(gen, (b, t, kh, d), dtype, dev)
    vc = _randn(gen, (b, t, kh, d), dtype, dev)
    out, lse = ops.decode_attention(q, kc, vc, pos, return_lse=True)
    torch.cuda.synchronize()
    want, want_lse = ref.ref_decode_attention(q, kc, vc, pos,
                                              return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h)
    if pos < 0:
        assert torch.all(lse == float("-inf")) and torch.all(out == 0)
        return
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-2)
    assert torch.equal(out, ops.decode_attention(q, kc, vc, pos))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("window,softcap,scale", [
    (100, None, None), (0, 5.0, None), (100, 50.0, 1 / 12),
    (1, 50.0, 1 / 12), (4096, 50.0, 1 / 12)])
def test_decode_attention_window_and_softcap(dev, d, window, softcap, scale,
                                             dtype):
    """K2 with gemma2's window and softcap (and a small cap, which bites
    on q at 3x unit scale) against the plain version. T = 700 over two
    KV heads at B = 2 takes 16 splits of 44 keys on the bf16 route; at pos
    340 a window of 100 starts at key 241, inside split 5 (220..263) and
    inside its chunk 220 + 16..31; at pos 291 it starts at 192, the first
    key of the second chunk of split 4 (176..219); at pos 60 the window
    has not yet cut; at 699 it starts at 600, inside split 13 (572..615)
    and inside a chunk."""
    b, t, h, kh = 2, 700, 14, 2
    gen = torch.Generator(device=dev).manual_seed(6)
    q = (3 * torch.randn((b, h, d), generator=gen, device=dev)).to(dtype)
    kc = _randn(gen, (b, t, kh, d), dtype, dev)
    vc = _randn(gen, (b, t, kh, d), dtype, dev)
    kw = dict(window=window, softcap=softcap, scale=scale)
    for pos in (0, 60, 291, 340, 699):
        before = ops.LAUNCHES["decode_attention"]
        out = ops.decode_attention(q, kc, vc, pos, **kw)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["decode_attention"] == before + 1
        torch.testing.assert_close(
            out.float(),
            ref.ref_decode_attention(q, kc, vc, pos, **kw).float(),
            **TOL[dtype], msg=lambda m, pos=pos: f"pos {pos}: {m}")


@pytest.mark.parametrize("b,t,pos", [(16, 192, 191), (1, 4416, 4415)])
def test_decode_attention_at_gemma2_shapes(dev, b, t, pos):
    """gemma2-27b's decode (bf16, GQA 32:16, D = 128, softcap 50, scale
    1/12, window 4096) at the last step of a B = 16 round and of the long
    B = 1 round, where the window cuts."""
    gen = torch.Generator(device=dev).manual_seed(7)
    q = (3 * torch.randn((b, 32, 128), generator=gen, device=dev)).to(
        torch.bfloat16)
    kc = _randn(gen, (b, t, 16, 128), torch.bfloat16, dev)
    vc = _randn(gen, (b, t, 16, 128), torch.bfloat16, dev)
    kw = dict(window=4096, softcap=50.0, scale=1 / 12)
    out = ops.decode_attention(q, kc, vc, pos, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out.float(), ref.ref_decode_attention(q, kc, vc, pos, **kw).float(),
        **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t", [(16, 1500, 1500), (16, 128, 1500)])
def test_flash_attention_at_whisper_shapes(dev, b, s, t, dtype):
    """whisper-large-v3's non-causal K1 launches (MHA 20:20, D = 64): the
    encoder at S = T = 1,500 and the cross-attention prefill at S = 128
    over T = 1,500, a T that no key tile divides. q at 3x unit scale, so
    the outputs over 1,500 keys stay O(1) and a lost key tile shows."""
    gen = torch.Generator(device=dev).manual_seed(8)
    q = (3 * torch.randn((b, s, 20, 64), generator=gen, device=dev)).to(dtype)
    k = _randn(gen, (b, t, 20, 64), dtype, dev)
    v = _randn(gen, (b, t, 20, 64), dtype, dev)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(
        out.float(), ref.ref_attention(q, k, v, causal=False).float(),
        **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [1499, 700])
def test_decode_attention_over_a_stacked_cross_cache_slice(dev, pos, dtype):
    """whisper-large-v3's cross-attention decode: K2 at B = 16 over one
    layer's slice ``cross_k[i]`` of a stacked (L, B, 1500, 20, 64) cache
    (MHA, g = 1; 1,500 keys, not a multiple of K2's 16-key chunk), at pos
    1499 (every key, the decode's) and 700; q at 3x unit scale."""
    gen = torch.Generator(device=dev).manual_seed(9)
    q = (3 * torch.randn((16, 20, 64), generator=gen, device=dev)).to(dtype)
    kc = _randn(gen, (3, 16, 1500, 20, 64), dtype, dev)
    vc = _randn(gen, (3, 16, 1500, 20, 64), dtype, dev)
    for i in range(3):
        before = ops.LAUNCHES["decode_attention"]
        out = ops.decode_attention(q, kc[i], vc[i], pos, scale=64 ** -0.5)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["decode_attention"] == before + 1
        torch.testing.assert_close(
            out.float(),
            ref.ref_decode_attention(q, kc[i], vc[i], pos).float(),
            **TOL[dtype])


def test_whisper_generate_launches_only_the_kernels(dev, monkeypatch):
    """A whisper-large-v3 rollout at full width cut to 2 encoder and 2
    decoder layers over 1,500 frames, with SDPA patched to raise: exactly
    2 + 2 * 2 K1 launches (encoder, self and cross prefill) and 2 * 2 K2
    a decode step (self and cross), finite logprobs."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.rl import rollout

    def refuse(*a, **k):
        raise AssertionError("a library attention on the whisper path")

    monkeypatch.setattr(F, "scaled_dot_product_attention", refuse)
    cfg = get_config("whisper-large-v3").replace(num_layers=2,
                                                 encoder_layers=2)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(10)
    params = model.init_params(gen, dev)
    frames = (0.02 * torch.randn((2, 1500, 1280), generator=gen,
                                 device=dev)).to(torch.bfloat16)
    prompt = torch.randint(3, cfg.vocab_size, (2, 16), generator=gen,
                           device=dev)
    ops.reset_launches()
    with torch.inference_mode():
        toks, logps, _ = rollout.rollout(
            model, params, prompt, gen,
            rollout.RolloutConfig(max_new_tokens=4, temperature=0.7),
            extra_inputs={"frames": frames})
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"flash_attention": 6, "decode_attention": 16,
                            "ssd": 0}
    assert toks.shape == (2, 4) and bool(torch.isfinite(logps).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,causal", [(16, 128, 128, True),
                                          (16, 128, 1601, False)])
def test_flash_attention_at_vision_shapes(dev, b, s, t, causal, dtype):
    """llama-3.2-vision-90b's K1 launches (GQA 64:8, g = 8, D = 128): the
    self-attention prefill, causal at S = T = 128, and the cross-attention
    prefill, non-causal at S = 128 over the T = 1,601 patch keys, a T no
    key tile divides; q at 3x unit scale."""
    gen = torch.Generator(device=dev).manual_seed(11)
    q = (3 * torch.randn((b, s, 64, 128), generator=gen,
                         device=dev)).to(dtype)
    k = _randn(gen, (b, t, 8, 128), dtype, dev)
    v = _randn(gen, (b, t, 8, 128), dtype, dev)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(
        out.float(),
        ref.ref_attention(q, k.repeat_interleave(8, 2),
                          v.repeat_interleave(8, 2), causal=causal).float(),
        **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,pos", [(1601, 1600), (1601, 800), (192, 191)])
def test_decode_attention_at_vision_shapes(dev, t, pos, dtype):
    """llama-3.2-vision-90b's K2 launches (GQA 64:8, D = 128) on the slices
    the model hands it: the cross decode over one group's ``cross_k[g]``
    of a stacked (G, B, 1601, K, D) cache (1,601 keys, not a multiple of
    K2's 16-key chunk) at pos 1,600 (every key, the decode's) and 800; the
    self decode over one layer's ``k[g][j]`` of a (G, per_group, B, 192, K,
    D) cache at its last step. q at 3x unit scale."""
    gen = torch.Generator(device=dev).manual_seed(12)
    q = (3 * torch.randn((16, 64, 128), generator=gen, device=dev)).to(dtype)
    lead = (2,) if t == 1601 else (2, 2)
    kc = _randn(gen, lead + (16, t, 8, 128), dtype, dev)
    vc = _randn(gen, lead + (16, t, 8, 128), dtype, dev)
    for idx in ((0,), (1,)) if t == 1601 else ((0, 1), (1, 0)):
        k, v = kc[idx], vc[idx]
        assert k.is_contiguous() and k.data_ptr() % 16 == 0
        before = ops.LAUNCHES["decode_attention"]
        out = ops.decode_attention(q, k, v, pos, scale=128 ** -0.5)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["decode_attention"] == before + 1
        torch.testing.assert_close(
            out.float(), ref.ref_decode_attention(q, k, v, pos).float(),
            **TOL[dtype])


def test_vision_generate_launches_only_the_kernels(dev, monkeypatch):
    """A llama-3.2-vision-90b rollout at full width cut to one group (4
    self layers and the gated cross layer, gates 1.0) over 1,601 patch
    embeddings, with SDPA patched to raise: exactly 5 K1 launches (4 self
    prefills and the cross prefill) and 5 K2 a decode step, finite
    logprobs, and logits that change with the patch embeddings."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.rl import rollout

    def refuse(*a, **k):
        raise AssertionError("a library attention on the vision path")

    monkeypatch.setattr(F, "scaled_dot_product_attention", refuse)
    cfg = get_config("llama-3.2-vision-90b").replace(num_layers=5)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(13)
    params = model.init_params(gen, dev)
    for g in ("gate_attn", "gate_mlp"):
        params["cross_layers"][g].fill_(1.0)
    # each row's patches share a component: at the seeded init every key
    # weighs alike, and the mean of independent patches' values is too
    # small to move the logits (chip_smoke.py phase 28)
    vision = (torch.randn((2, 1601, 8192), generator=gen, device=dev)
              + torch.randn((2, 1, 8192), generator=gen, device=dev)).to(
        torch.bfloat16)
    prompt = torch.randint(3, cfg.vocab_size, (2, 16), generator=gen,
                           device=dev)
    ops.reset_launches()
    with torch.inference_mode():
        toks, logps, _ = rollout.rollout(
            model, params, prompt, gen,
            rollout.RolloutConfig(max_new_tokens=4, greedy=True),
            extra_inputs={"vision": vision})
        torch.cuda.synchronize()
        assert ops.LAUNCHES == {"flash_attention": 5,
                                "decode_attention": 20, "ssd": 0}
        assert toks.shape == (2, 4) and bool(torch.isfinite(logps).all())
        other = model.forward(params, {"tokens": prompt,
                                       "vision": -vision})[0]
        same = model.forward(params, {"tokens": prompt, "vision": vision})[0]
    assert float((other - same).abs().max()) > \
        2.0 ** -6 * float(same.abs().max())


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
    q = torch.randn(1, 4, 8, 144, device=dev)          # D > 128: no kernel
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


@pytest.mark.parametrize("b,s,h,chunk", [
    (16, 128, 80, 256),        # the training shape: one chunk of 128
    (2, 300, 8, 256),          # ragged: a padded second chunk
])
def test_ssd_function_grads_match_ssd_chunked_autograd(dev, b, s, h, chunk):
    """K3 under its autograd Function: one K3 launch for the forward, none
    for the backward; y and the x, dt, A, B, C gradients against plain
    autograd through ``models/mamba2.py::ssd_chunked`` (bf16 x, B, C as
    the model passes them), within 5e-2 * max|expect|; under no_grad (the
    serving path) y has no grad_fn."""
    from repro_torch.models.mamba2 import ssd_chunked
    gen = torch.Generator(device=dev).manual_seed(10)
    x, dt, A, B, C = _ssd_inputs(gen, b, s, h, 64, 128, torch.bfloat16,
                                 torch.bfloat16, dev)
    ct = _randn(gen, (b, s, h, 64), torch.bfloat16, dev)
    grads, outs = [], []
    for fn in (lambda *a: ops.ssd(*a, chunk=chunk),
               lambda *a: ssd_chunked(*a, min(chunk, s))):
        leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
        before = ops.LAUNCHES["ssd"]
        y, _ = fn(*leaves)
        assert y.grad_fn is not None
        y.backward(ct)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["ssd"] - before == (1 if not outs else 0)
        outs.append(y.detach().float())
        grads.append([t.grad.float() for t in leaves])
    for got, want in [*zip(*grads), tuple(outs)]:
        bound = 5e-2 * want.abs().max().item()
        assert (got - want).abs().max().item() <= bound
    with torch.no_grad():
        y, _ = ops.ssd(x, dt, A, B, C)
    assert y.grad_fn is None


@pytest.mark.parametrize("arch", ["paper-qwen3-30b-a3b",
                                  "granite-moe-3b-a800m"])
def test_moe_apply_on_the_card_matches_the_cpu(dev, arch):
    """One MoE layer at full width (B=4 S=64: capacity 8 or 16 a row)
    on the card against the CPU from the same seeded parameters: the
    routing agrees except at near-ties of the f32 router (at most 0.1 % of
    the choices), the output within 5e-2 at the rows routed alike, the aux
    loss within 2e-3; and two runs on the card give the same bits (the
    combine has no atomics)."""
    from repro_torch.configs import get_config
    from repro_torch.models import common, moe

    cfg = get_config(arch)
    params = common.init_params(torch.Generator().manual_seed(0),
                                moe.moe_param_specs(cfg))
    x = torch.randn((4, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    card = {k: v.to(dev) for k, v in params.items()}
    out, aux = moe.moe_apply(params, cfg, x)
    got, got_aux = moe.moe_apply(card, cfg, x.to(dev))
    again, _ = moe.moe_apply(card, cfg, x.to(dev))
    assert torch.equal(got, again)
    ids = moe.route(params["router"], cfg, x)[1]
    got_ids = moe.route(card["router"], cfg, x.to(dev))[1].cpu()
    kept = (ids[..., :, None] == got_ids[..., None, :]).any(-1)
    assert (~kept).sum() <= 1e-3 * kept.numel()
    rows = kept.all(-1).all(-1)
    assert rows.any()
    torch.testing.assert_close(got.cpu().float()[rows], out.float()[rows],
                               **TOL[torch.bfloat16])
    torch.testing.assert_close(got_aux.cpu(), aux, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch,overrides", [
    ("qwen2-0.5b", {}),                          # head_dim 16: K1, K2 built
    ("qwen2-0.5b", {"head_dim": 64}),
    ("mamba2-2.7b", {})])
def test_cost_model_counts_the_same_on_the_card_and_on_meta(dev, arch,
                                                            overrides):
    """``launch/hlo_cost`` over a reduced config's prefill, one decode step
    and one update_actor: the FLOPs, bytes, ops and per-kernel launches
    and work counted on the card equal those counted on ``meta`` tensors,
    and each kernel's counted launches equal the change in LAUNCHES. The
    peak of live bytes tracked on the card equals the one on ``meta``, and
    lies within 10 % + 64 MiB of ``max_memory_allocated()`` above what was
    allocated before the step."""
    from repro_torch.configs import ShapeSpec, reduced_config
    from repro_torch.launch import hlo_cost
    from repro_torch.models.registry import build_model
    from repro_torch.rl import grpo
    from repro_torch.train import train_state as tst

    model = build_model(reduced_config(arch).replace(**overrides))
    gen = torch.Generator(device=dev).manual_seed(0)
    state = tst.init(model, gen, device=dev)
    shapes = [ShapeSpec("t", "train", 32, 4), ShapeSpec("p", "prefill", 32, 2),
              ShapeSpec("d", "decode", 40, 2)]
    card = [(grpo.make_update_actor(model),
             (state, model.dummy_batch(gen, shapes[0]))),
            (grpo.make_prefill(model),
             (state.params, model.dummy_batch(gen, shapes[1]))),
            (grpo.make_decode(model),
             (state.params, dict(model.init_cache(gen, 2, 40, dev), pos=39),
              model.dummy_batch(gen, shapes[2])))]
    meta = [(tst.abstract(model), model.abstract_batch(shapes[0])),
            (model.abstract_params(), model.abstract_batch(shapes[1])),
            (model.abstract_params(), model.abstract_cache(2, 40, 39),
             model.abstract_batch(shapes[2]))]
    keys = ("flops", "traffic_bytes", "ops", "kernels")
    launched = []
    for (step, args), meta_args in zip(card, meta):
        ops.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        with hlo_cost.Counter() as counter:
            step(*args)
            torch.cuda.synchronize()
        card_peak = torch.cuda.max_memory_allocated(dev) - before
        on_card = counter.stats()
        assert {k: v["launches"] for k, v in on_card["kernels"].items()} \
            == ops.LAUNCHES
        on_meta = hlo_cost.analyze(step, *meta_args)
        assert {k: on_card[k] for k in keys} == {k: on_meta[k] for k in keys}
        assert on_card["peak_live_bytes"] == on_meta["peak_live_bytes"]
        assert abs(on_meta["peak_live_bytes"] - card_peak) <= \
            0.1 * card_peak + 64 * 2 ** 20
        launched.append(sum(ops.LAUNCHES.values()))
    # update_actor and the prefill launch K1 or K3; mamba2's decode step is
    # plain PyTorch (no kernel), a transformer's runs K2
    assert launched[0] > 0 and launched[1] > 0
    assert launched[2] == (0 if model.cfg.family == "ssm"
                           else model.cfg.num_layers)


# ------------------------------------------ K1 with a query offset (cache)

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [2, 16, 128])
@pytest.mark.parametrize("b,cache_pos,h,kh,d,window,softcap,scale", [
    (4, 150, 14, 2, 64, 0, None, None),          # qwen2-0.5b, GQA 14:2
    (1, 4120, 32, 16, 128, 4096, 50.0, 1 / 12),  # gemma2-27b: the window cuts
    (2, 550, 32, 32, 112, 0, None, None),        # zamba2-7b, MHA, D = 112
    (2, 301, 14, 2, 64, 100, None, None),        # a window cutting mid-tile
], ids=["qwen2", "gemma2", "zamba2", "window_mid_tile"])
def test_flash_attention_with_a_query_offset_reads_the_cache_in_place(
        dev, b, cache_pos, h, kh, d, window, softcap, scale, s, dtype):
    """A multi-token cache write: s queries at positions cache_pos.. over
    the first cache_pos + s rows of a (B, T_cap, K, D) cache, passed as a
    view (the kernel reads it through its batch stride: no copy), against
    the plain version with the same offset; cache_pos sits mid-tile."""
    from repro_torch.kernels import flash_attention as tfa

    gen = torch.Generator(device=dev).manual_seed(s)
    t, t_cap = cache_pos + s, cache_pos + 200
    q = 3 * _randn(gen, (b, s, h, d), dtype, dev)
    kc = _randn(gen, (b, t_cap, kh, d), dtype, dev)
    vc = _randn(gen, (b, t_cap, kh, d), dtype, dev)
    k, v = kc[:, :t], vc[:, :t]
    # a view of the cache (one sequence's is contiguous all the same)
    assert (b == 1 or not k.is_contiguous()) and tfa._rows_in_place(k, v)
    kw = dict(window=window, softcap=softcap, scale=scale)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, q_off=cache_pos, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    g = h // kh
    expect = ref.ref_attention(q, k.repeat_interleave(g, 2),
                               v.repeat_interleave(g, 2), q_off=cache_pos,
                               **kw)
    torch.testing.assert_close(out.float(), expect.float(), **TOL[dtype])


def test_query_offset_zero_with_a_whole_cache_is_the_prefill(dev):
    """q_off = 0 over a contiguous (B, T, K, D) tensor is the prefill
    launch as before: bit for bit the same output through either call."""
    gen = torch.Generator(device=dev).manual_seed(1)
    q = _randn(gen, (4, 128, 14, 64), torch.bfloat16, dev)
    k = _randn(gen, (4, 128, 2, 64), torch.bfloat16, dev)
    assert torch.equal(ops.flash_attention(q, k, k),
                       ops.flash_attention(q, k, k, q_off=0))


def test_attn_apply_with_several_new_tokens_runs_k1_on_the_card(dev):
    """The model's multi-token cache write launches K1 once and agrees
    with the same layer on the CPU (the XLA branch), output and cache."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import common
    from repro_torch.models import layers as tl

    cfg = reduced_config("gemma2-27b")
    gen = torch.Generator().manual_seed(3)
    params = common.init_params(gen, tl.attn_param_specs(cfg))
    x = torch.randn(2, 5, cfg.d_model, generator=gen).to(torch.bfloat16)
    ck = torch.randn(2, 30, cfg.num_kv_heads, 16, generator=gen).to(
        torch.bfloat16)
    ck[:, 20:] = 0
    pos = (20 + torch.arange(5))[None].expand(2, 5)
    cpu = {"k": ck.clone(), "v": ck.clone()}
    card = {n: t.to(dev) for n, t in cpu.items()}
    want, _ = tl.attn_apply(params, cfg, x, positions=pos, window=8,
                            cache=cpu, cache_pos=20)
    ops.reset_launches()
    got, _ = tl.attn_apply({k: t.to(dev) for k, t in params.items()}, cfg,
                           x.to(dev), positions=pos.to(dev), window=8,
                           cache=card, cache_pos=20)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"flash_attention": 1, "decode_attention": 0,
                            "ssd": 0}
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               **TOL[torch.bfloat16])
    for n in ("k", "v"):
        torch.testing.assert_close(card[n].cpu().float(), cpu[n].float(),
                                   **TOL[torch.bfloat16])


# ------------------------------------------------- the examples' head widths

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [12, 16, 32])
@pytest.mark.parametrize("s,t,causal,window", [
    (100, 100, True, 0), (100, 100, True, 37), (77, 131, False, 0)])
def test_flash_attention_at_narrow_head_widths(dev, d, s, t, causal, window,
                                               dtype):
    """K1 built at D = 16 and 32, and D = 12 padded to 16 with zeros at the
    true width's scale."""
    gen = torch.Generator(device=dev).manual_seed(d)
    q = 3 * _randn(gen, (2, s, 4, d), dtype, dev)
    k = _randn(gen, (2, t, 2, d), dtype, dev)
    v = _randn(gen, (2, t, 2, d), dtype, dev)
    kw = dict(causal=causal, window=window)
    out = ops.flash_attention(q, k, v, **kw)
    assert out.shape == q.shape and out.is_contiguous()
    expect = ref.ref_attention(q, k.repeat_interleave(2, 2),
                               v.repeat_interleave(2, 2), **kw)
    torch.testing.assert_close(out.float(), expect.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [12, 16, 32])
@pytest.mark.parametrize("b,t,pos,window", [
    (4, 40, 30, 0), (8, 18, 17, 0), (1, 4096, 4000, 0), (1, 4096, 4000, 1000),
    (1, 4096, 2000, 77)])
def test_decode_attention_at_narrow_head_widths(dev, d, b, t, pos, window,
                                                dtype):
    """K2 at D = 12 (padded), 16 and 32; at B=1 T=4096 the bf16 route runs
    16 splits, more than D / 4, so each row's m and l reach several blocks
    of the cluster."""
    gen = torch.Generator(device=dev).manual_seed(d + t)
    q = 3 * _randn(gen, (b, 4, d), dtype, dev)
    kc = _randn(gen, (b, t, 2, d), dtype, dev)
    vc = _randn(gen, (b, t, 2, d), dtype, dev)
    out = ops.decode_attention(q, kc, vc, pos, window=window)
    expect = ref.ref_decode_attention(q, kc, vc, pos, window=window)
    torch.testing.assert_close(out.float(), expect.float(), **TOL[dtype])
    if t == 4096 and dtype == torch.bfloat16:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert tdec.splits_for(b, 2, t, sms) == 16 > 16 // 4


@pytest.mark.parametrize("d", [16, 32])
def test_narrow_head_widths_keep_clusters_resident(dev, d):
    assert tdec.max_active_clusters(d, 1) > 0
    assert tdec.max_active_clusters(d, tdec.MAX_SPLITS) > 0
