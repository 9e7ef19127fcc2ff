"""The port's dense model, held against the JAX package on the CPU.

Layers are compared on numpy-seeded inputs with the same parameters on
both sides. Whole-model logits of ``reduced_config("qwen2-0.5b")`` use the
JAX package's seeded init carried across by ``models/convert.py``.

Tolerances: f32 layer outputs 2e-3 (sums taken in another order); bf16
layer outputs 5e-2 as in tests/test_kernels.py. Whole-model bf16 logits:
both packages round every einsum output to bf16 (8 significant bits) and
the logits are a bf16 product (``layers.py:374``), so a one-ulp
disagreement at the largest logit is 2^-8 of it; the tolerance allows four
such ulps: max |diff| <= 2^-6 * max |logit|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models import layers as jl
from repro.models.common import canonical_flat as j_canonical_flat
from repro.models.registry import build_model as j_build_model
from repro.rl.rollout import _pad_cache as j_pad_cache
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import common, convert
from repro_torch.models import layers as tl
from repro_torch.models.registry import build_model
from repro_torch.rl.rollout import _pad_cache

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
CFG = reduced_config("qwen2-0.5b")


def _both(arr, dtype):
    j = jnp.asarray(arr, jnp.float32).astype(getattr(jnp, dtype))
    t = torch.from_numpy(np.asarray(arr, np.float32)).to(getattr(torch, dtype))
    return j, t


def _close(j, t, dtype):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **TOL[dtype])


def _params(specs_fn, dtype, seed):
    """Random params for a layer, as {key: (jax, torch)} trees."""
    rng = np.random.default_rng(seed)
    specs = common.canonical_flat(specs_fn())
    flat = {k: _both(rng.standard_normal(s.shape) * 0.2, dtype)
            for k, s in specs.items()}
    tmpl = specs_fn()
    return (common.canonical_unflatten(tmpl, {k: v[0] for k, v in flat.items()}),
            common.canonical_unflatten(tmpl, {k: v[1] for k, v in flat.items()}))


def _reference_params(seed=0):
    jm = j_build_model(j_reduced_config("qwen2-0.5b"))
    jp = jm.init_params(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in
            j_canonical_flat(jp, is_leaf=lambda x: hasattr(x, "shape")).items()}
    return jm, jp, flat


def test_convert_round_trip_is_bit_exact():
    _, _, flat = _reference_params()
    params = convert.params_from_reference(flat, CFG)
    assert set(common.canonical_flat(params)) == set(flat)
    back = convert.params_to_reference(params)
    assert set(back) == set(flat)
    for k, arr in flat.items():
        assert back[k].dtype == arr.dtype and back[k].shape == arr.shape, k
        np.testing.assert_array_equal(back[k].view(np.uint16),
                                      arr.view(np.uint16), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _both(rng.standard_normal((2, 5, 64)) * 3, dtype)
    js, ts = _both(rng.standard_normal(64) * 0.1, dtype)
    _close(jl.rms_norm(jx, js, 1e-6), tl.rms_norm(tx, ts, 1e-6), dtype)


def test_rope_matches_jax_at_theta_1e6():
    rng = np.random.default_rng(1)
    jx, tx = _both(rng.standard_normal((2, 7, 3, 64)), "float32")
    pos = np.array([[0, 1, 5, 64, 127, 191, 1000]] * 2, np.int32)
    out = tl.rope(tx, torch.from_numpy(pos), 1e6)
    _close(jl.rope(jx, jnp.asarray(pos), 1e6), out, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_jax(dtype):
    jp, tp = _params(lambda: tl.mlp_param_specs(CFG, CFG.d_ff), dtype, 2)
    jx, tx = _both(np.random.default_rng(3).standard_normal((2, 5, 64)), dtype)
    _close(jl.mlp_apply(jp, CFG, jx), tl.mlp_apply(tp, CFG, tx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_apply_prefill_and_cache_branch_match_jax(dtype):
    jp, tp = _params(lambda: tl.attn_param_specs(CFG), dtype, 4)
    rng = np.random.default_rng(5)
    b, s, t = 2, 9, 16
    jx, tx = _both(rng.standard_normal((b, s, 64)), dtype)
    jpos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    tpos = torch.arange(s)[None].expand(b, s)
    jo, jkv = jl.attn_apply(jp, CFG, jx, positions=jpos)
    to, tkv = tl.attn_apply(tp, CFG, tx, positions=tpos)
    _close(jo, to, dtype)
    _close(jkv["k"], tkv["k"], dtype)
    # cache branch: one decode token at pos 9, then a 3-token write at 10
    pad = [(0, 0), (0, t - s), (0, 0), (0, 0)]
    jc = {n: jnp.pad(jkv[n], pad) for n in ("k", "v")}
    tc = {n: torch.cat([tkv[n], tkv[n].new_zeros((b, t - s, 2, 16))], 1)
          for n in ("k", "v")}
    for pos, n_new in ((s, 1), (s + 1, 3)):
        jx, tx = _both(rng.standard_normal((b, n_new, 64)), dtype)
        p = np.arange(pos, pos + n_new)[None].repeat(b, 0)
        jo, jc = jl.attn_apply(jp, CFG, jx, positions=jnp.asarray(p),
                               cache=jc, cache_pos=pos)
        to, tc = tl.attn_apply(tp, CFG, tx, positions=torch.from_numpy(p),
                               cache=tc, cache_pos=pos)
        _close(jo, to, dtype)
        _close(jc["v"], tc["v"], dtype)


def test_prefill_and_teacher_forced_decode_logits_match_jax():
    jm, jp, flat = _reference_params(seed=7)
    tm = build_model(CFG)
    tp = convert.params_from_reference(flat, CFG)
    rng = np.random.default_rng(8)
    b, p, n = 2, 12, 8
    prompt = rng.integers(0, CFG.vocab_size, (b, p)).astype(np.int32)
    forced = rng.integers(0, CFG.vocab_size, (b, n)).astype(np.int32)

    def check(j, t):
        j = np.asarray(j)
        atol = 2.0 ** -6 * np.abs(j).max()
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=atol)

    jfwd = jax.jit(lambda pp, tok: jm.forward(pp, {"tokens": tok},
                                              return_cache=True))
    jdec = jax.jit(lambda pp, c, tok: jm.decode_step(pp, c, {"tokens": tok}))
    jlog, _, jc = jfwd(jp, jnp.asarray(prompt))
    tlog, _, tc = tm.forward(tp, {"tokens": torch.from_numpy(prompt).long()},
                             return_cache=True)
    check(jlog, tlog)
    assert tc["pos"] == p and tuple(tc["k"].shape) == tuple(jc["k"].shape)
    jc, tc = j_pad_cache(jc, n), _pad_cache(tc, n)
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape)
    for i in range(n):
        tok = forced[:, i:i + 1]
        jlog, jc = jdec(jp, jc, jnp.asarray(tok))
        tlog, tc = tm.decode_step(tp, tc, {"tokens": torch.from_numpy(tok).long()})
        check(jlog, tlog)
    assert tc["pos"] == p + n


def test_seeded_init_is_deterministic_and_keyed_like_jax():
    _, _, flat = _reference_params()
    m = build_model(CFG)
    a = m.init_params(torch.Generator().manual_seed(3))
    b = m.init_params(torch.Generator().manual_seed(3))
    fa, fb = common.canonical_flat(a), common.canonical_flat(b)
    assert set(fa) == set(flat)
    for k in fa:
        assert tuple(fa[k].shape) == flat[k].shape, k
        assert torch.equal(fa[k], fb[k]), k
    assert m.param_count() == sum(a.size for a in flat.values())


@pytest.mark.parametrize("name,field", [
    ("gemma2-27b", "sliding_window"), ("granite-moe-3b-a800m", "MoE"),
    ("zamba2-7b", "hybrid"), ("whisper-large-v3", "whisper")])
def test_unported_configs_raise_naming_the_roadmap(name, field):
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as e:
        build_model(get_config(name)).param_specs()
    assert field in str(e.value)
