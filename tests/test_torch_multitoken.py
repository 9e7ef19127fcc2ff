"""Multi-token cache writes, held against the JAX package on the CPU.

``attn_apply`` with a cache and ``s`` > 1 new tokens (the reference's
short-chunk decode, ``repro/models/layers.py:257-300``): the queries sit at
``cache_pos .. cache_pos + s - 1`` over the keys up to ``cache_pos + s -
1``, causal, windowed and soft-capped. On the card the port runs K1 with a
query offset over the cache's first ``cache_pos + s`` rows; on the CPU it
runs the port of the reference's XLA branch, held here against the
reference's ``attn_apply`` at reduced widths: qwen2's GQA 4:2, gemma2's
window of 8 (cut by the write) and softcap 50, and MHA at head_dim 112.
``s`` = 40 is above the reduced configs' ``attn_q_chunk`` of 32, so both
sides block the queries. The weights are the reference's seeded init,
carried across by ``models/convert.py``; inputs are made with numpy.

K1's plain route with a query offset (``ops.flash_attention(...,
q_off=)`` on the CPU, the version the kernel is held against on the card)
is held against ``xla_attention`` and the reference's ``attention_core``
with the same positions and key mask, and its counted work against the
mask it applies.

Tolerances, as tests/test_kernels.py: f32 rtol = atol = 2e-3 (sums taken
in another order), bf16 5e-2.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models import layers as jl
from repro.models.common import canonical_flat as j_canonical_flat
from repro.models.registry import build_model as j_build_model
from repro_torch.configs import reduced_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import xla_attention
from repro_torch.models import convert
from repro_torch.models import layers as tl

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
IS_ARR = dict(is_leaf=lambda x: hasattr(x, "shape"))
B = 2
# (arch, config replacements, the attention layer's subtree, window)
CASES = {
    "qwen2_gqa": ("qwen2-0.5b", {}, ("layers", "attn"), 0),
    "gemma2_window_softcap": ("gemma2-27b", {}, ("layers", "attn"), 8),
    "mha_d112": ("zamba2-7b", {"head_dim": 112}, ("shared_attn", "attn"), 0),
}


@functools.lru_cache(maxsize=None)
def _seeded(case):
    """The case's configs and the reference's seeded parameters on both
    sides (the port's through ``convert``), made once."""
    arch, replace, _, _ = CASES[case]
    jcfg = j_reduced_config(arch).replace(**replace)
    cfg = reduced_config(arch).replace(**replace)
    jp = j_build_model(jcfg).init_params(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in j_canonical_flat(jp, **IS_ARR).items()}
    return jcfg, cfg, jp, convert.params_from_reference(flat, cfg)


def _layer(case, dtype):
    """One attention layer's parameters of the case, both sides, cast to
    ``dtype``."""
    jcfg, cfg, jp, tp = _seeded(case)
    path = CASES[case][2]
    for key in path:
        jp, tp = jp[key], tp[key]
    stacked = path[0] == "layers"
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree.map(lambda x: (x[0] if stacked else x).astype(jdt), jp)
    tp = {k: (v[0] if stacked else v).to(tdt) for k, v in tp.items()}
    return jcfg, cfg, jp, tp


def _both(arr, dtype):
    j = jnp.asarray(arr, jnp.float32).astype(getattr(jnp, dtype))
    t = torch.from_numpy(np.asarray(arr, np.float32)).to(getattr(torch, dtype))
    return j, t


def _close(j, t, dtype, what):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               err_msg=what, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [2, 5, 40])
@pytest.mark.parametrize("case", sorted(CASES))
def test_multi_token_cache_write_matches_jax(case, s, dtype):
    """A prefill of ``cache_pos`` tokens fills the cache, then ``s`` new
    tokens are written at ``cache_pos`` (mid-capacity: the slots past the
    write stay masked) and attend the prefix; the outputs and the
    written cache agree with the reference's."""
    window = CASES[case][3]
    jcfg, cfg, jp, tp = _layer(case, dtype)
    rng = np.random.default_rng(s)
    cache_pos = 11                   # past gemma2's window of 8
    t_cap = cache_pos + s + 3
    jx, tx = _both(rng.standard_normal((B, cache_pos, cfg.d_model)), dtype)
    pos = np.arange(cache_pos)[None].repeat(B, 0)
    _, jkv = jl.attn_apply(jp, jcfg, jx, positions=jnp.asarray(pos),
                           window=window)
    _, tkv = tl.attn_apply(tp, cfg, tx, positions=torch.from_numpy(pos),
                           window=window)
    pad = [(0, 0), (0, t_cap - cache_pos), (0, 0), (0, 0)]
    jc = {n: jnp.pad(jkv[n], pad) for n in ("k", "v")}
    tc = {n: torch.nn.functional.pad(tkv[n], (0, 0, 0, 0, 0,
                                              t_cap - cache_pos))
          for n in ("k", "v")}
    jx, tx = _both(rng.standard_normal((B, s, cfg.d_model)), dtype)
    pos = np.arange(cache_pos, cache_pos + s)[None].repeat(B, 0)
    jo, jc = jl.attn_apply(jp, jcfg, jx, positions=jnp.asarray(pos),
                           window=window, cache=jc, cache_pos=cache_pos)
    to, tc = tl.attn_apply(tp, cfg, tx, positions=torch.from_numpy(pos),
                           window=window, cache=tc, cache_pos=cache_pos)
    _close(jo, to, dtype, "attention output")
    for n in ("k", "v"):
        _close(jc[n], tc[n], dtype, f"cache {n}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opts", [
    dict(h=4, kh=2, d=16),
    dict(h=4, kh=2, d=16, window=8, softcap=50.0, scale=0.1),
    dict(h=4, kh=4, d=112),
    dict(h=4, kh=2, d=12, window=5),
], ids=["gqa", "window_softcap", "mha_d112", "d12_window"])
@pytest.mark.parametrize("s,cache_pos", [(2, 13), (16, 7), (40, 30)])
def test_plain_k1_with_a_query_offset_matches_xla(opts, s, cache_pos,
                                                  dtype):
    """``ops.flash_attention(q, k[:, :t], v[:, :t], q_off=cache_pos)`` on
    the CPU, over a view of the cache's first t = cache_pos + s rows,
    against the port's ``xla_attention`` and the reference's
    ``attention_core`` over the whole cache with the query positions and
    the key mask of ``attn_apply``."""
    h, kh, d = opts["h"], opts["kh"], opts["d"]
    kw = {k: v for k, v in opts.items() if k in ("window", "softcap",
                                                  "scale")}
    scale = kw.get("scale", d ** -0.5)
    rng = np.random.default_rng(cache_pos)
    t = cache_pos + s
    t_cap = t + 5
    jq, tq = _both(rng.standard_normal((B, s, h, d)), dtype)
    jk, tk = _both(rng.standard_normal((B, t_cap, kh, d)), dtype)
    jv, tv = _both(rng.standard_normal((B, t_cap, kh, d)), dtype)
    out = ops.flash_attention(tq, tk[:, :t], tv[:, :t], causal=True,
                              q_off=cache_pos, **kw)
    assert out.shape == (B, s, h, d) and out.is_contiguous()
    positions = cache_pos + np.arange(s)[None].repeat(B, 0)
    mask = np.arange(t_cap) < t
    xla = xla_attention(tq, tk, tv, causal=True,
                        q_positions=torch.from_numpy(positions),
                        kv_mask=torch.from_numpy(mask), q_chunk=32,
                        **dict(kw, scale=scale))
    _close(np.asarray(xla.float()), out, dtype, "against xla_attention")
    ref = jl.attention_core(jq, jk, jv, q_positions=jnp.asarray(positions),
                            kv_positions=jnp.arange(t_cap), causal=True,
                            window=kw.get("window", 0),
                            softcap=kw.get("softcap"), scale=scale,
                            kv_mask=jnp.asarray(mask), q_chunk=32)
    _close(ref, out, dtype, "against the reference's attention_core")


@pytest.mark.parametrize("window", [0, 6])
def test_offset_work_counts_the_pairs_and_keys_the_masks_keep(window):
    """K1's counted work with a query offset: 4 FLOPs per head dim per
    attended (query, key) pair, q and the output once, and the K and V
    rows from the window's first key on."""
    b, s, h, kh, d, q_off = 2, 5, 4, 2, 16, 9
    t = q_off + s
    p = q_off + np.arange(s)[:, None]
    key = np.arange(t)[None]
    keep = key <= p
    if window:
        keep &= key > p - window
    flops, nbytes = ops.flash_attention_work(b, s, t, h, kh, d, 2,
                                             window=window, q_off=q_off)
    assert flops == 4 * b * h * d * int(keep.sum())
    first = int(np.argmax(keep.any(0)))
    assert nbytes == (2 * b * s * h * d + 2 * b * (t - first) * kh * d) * 2
    # without an offset the work is the prefill's, all T keys read
    assert ops.flash_attention_work(b, s, s, h, kh, d, 2, window=window) == \
        ops.flash_attention_work(b, s, s, h, kh, d, 2, window=window,
                                 q_off=0)
