"""The port's attention kernels, held against the JAX package on the CPU.

On the CPU the port's wrappers run the kernels' plain PyTorch versions;
they are compared with the JAX Pallas kernels run in interpret mode, as
tests/test_kernels.py runs them. Inputs are made with numpy from a seed and
handed to both packages (bf16 inputs are rounded from the same f32 values
by both). Tolerances are those of tests/test_kernels.py: f32 2e-3, bf16
5e-2 (bf16 keeps 8 significant bits and the two sides round the
probabilities and the output at different points). The CUDA kernels
themselves are checked on the card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd as tssd

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _pair(arr: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(arr, jnp.float32).astype(getattr(jnp, dtype))
    t = torch.from_numpy(arr.astype(np.float32)).to(getattr(torch, dtype))
    return j, t


def _qkv(b, s, h, kh, d, dtype, seed=0, t=None):
    rng = np.random.default_rng(seed)
    t = t or s
    return [_pair(rng.standard_normal(shape).astype(np.float32), dtype)
            for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d))]


def _close(jax_out, torch_out, dtype):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kh,d", [
    (1, 128, 4, 4, 64),      # MHA
    (2, 256, 8, 2, 64),      # GQA 4:1
    (1, 192, 4, 1, 128),     # MQA + non-block-multiple seq
    (2, 128, 14, 2, 64),     # qwen2-0.5b: GQA 14:2, g = 7
    (1, 200, 14, 2, 64),     # g = 7 at a ragged S
])
def test_flash_attention_plain_matches_jax(b, s, h, kh, d, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(b, s, h, kh, d, dtype)
    expect = jops.flash_attention(jq, jk, jv, causal=True, block_q=64,
                                  block_k=64)
    _close(expect, tops.flash_attention(tq, tk, tv, causal=True), dtype)


@pytest.mark.parametrize("h,kh,window,softcap,scale", [
    (4, 2, 0, None, None), (4, 2, 32, None, None), (4, 2, 64, None, None),
    (4, 4, 0, 50.0, 0.125),                      # gemma2-style softcap
    (14, 2, 64, None, None), (14, 2, 0, 50.0, 0.125),   # g = 7
])
def test_flash_attention_window_softcap_matches_jax(h, kh, window, softcap,
                                                    scale):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 128, h, kh, 64, "float32", seed=1)
    kw = dict(causal=True, window=window, softcap=softcap, scale=scale)
    expect = jops.flash_attention(jq, jk, jv, block_q=64, block_k=64, **kw)
    _close(expect, tops.flash_attention(tq, tk, tv, **kw), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kh,t,pos", [
    (8, 2, 256, 0), (8, 2, 256, 63), (8, 2, 256, 100), (8, 2, 256, 255),
    (14, 2, 192, 127), (14, 2, 192, 191),    # qwen2-0.5b decode, g = 7
])
def test_decode_attention_plain_matches_jax(h, kh, t, pos, dtype):
    rng = np.random.default_rng(3)
    b, d = 2, 64
    (jq, tq), (jk, tk), (jv, tv) = [
        _pair(rng.standard_normal(shape).astype(np.float32), dtype)
        for shape in ((b, h, d), (b, t, kh, d), (b, t, kh, d))]
    expect = jops.decode_attention(jq, jk, jv, pos, block_k=64)
    _close(expect, tops.decode_attention(tq, tk, tv, pos), dtype)


def test_cpu_wrappers_use_plain_version_and_count_nothing():
    tops.reset_launches()
    q = torch.randn(1, 16, 4, 64)
    k = torch.randn(1, 16, 2, 64)
    tops.flash_attention(q, k, k)
    tops.decode_attention(q[:, 0], k, k, 5)
    tops.ssd(q, torch.rand(1, 16, 4), -torch.rand(4), k[:, :, :1],
             k[:, :, :1])
    assert tops.LAUNCHES == {"flash_attention": 0, "decode_attention": 0,
                             "ssd": 0}


def test_launchers_reject_cpu_tensors_before_building():
    q = torch.randn(1, 16, 4, 64)
    k = torch.randn(1, 16, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_attention(q[:, 0], k, k, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_chunk_scan(q, torch.rand(1, 16, 4), -torch.rand(4),
                            k[:, :, :1], k[:, :, :1], chunk=8)


def test_build_compiles_each_source_for_sm90a(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    cmds = build.compile_commands(tmp_path)
    srcs = build.sources()
    assert {p.name for p in srcs} >= {"flash_attention.cu",
                                      "decode_attention.cu", "ssd.cu"}
    assert len(cmds) == len(srcs) + 1            # one nvcc each, then link
    for cmd in cmds:
        assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmds[-1][-len(srcs):] == [str(tmp_path / (p.stem + ".o"))
                                     for p in srcs]
    before = build.source_hash()
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-G"])
    assert build.source_hash() != before
