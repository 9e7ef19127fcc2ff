"""The port's gemma2 slice, held against the JAX package on the CPU.

At ``reduced_config("gemma2-27b")``: 4 layers in 2 groups of a local layer
(sliding window 8) and a global one, d_model 64, 4 query heads and 2 KV
heads of width 16, the attention logit softcap 50 and the final one 30,
post-norms, the sqrt(d_model) embedding scale (8.0 at d_model 64) and the
tanh-approximate GELU MLP. The JAX package's seeded parameters are carried
across by ``models/convert.py``; inputs are made with numpy from a seed.

The JAX side runs op by op (``jax.disable_jit``), as in
``tests/test_torch_hybrid.py``: its GELU is a chain of bf16 ops, each
rounded, where ``F.gelu(approximate="tanh")`` rounds once, and compiled,
XLA skips roundings of its own. Greedy choices are held as there
(``_held_tokens``).

Tolerances: bf16 logits at 2^-6 * max |logit| (four bf16 ulps of the
largest logit, tests/test_torch_model.py); bf16 cache entries and
attention outputs rtol = atol = 5e-2, f32 ones 2e-3, as
tests/test_kernels.py.
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
from repro.rl import rollout as jrollout
from repro_torch.configs import reduced_config
from repro_torch.kernels import ref
from repro_torch.models import common, convert
from repro_torch.models import transformer as ttransformer
from repro_torch.models.registry import build_model
from repro_torch.rl import rollout as trollout
from test_torch_hybrid import _check_logits, _held_tokens, _np

torch.set_num_threads(1)

ARCH = "gemma2-27b"
CFG = reduced_config(ARCH)
J_CFG = j_reduced_config(ARCH)
TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
B, P, N_NEW = 2, 12, 8           # decode reaches position 19: twice the window
IS_ARR = dict(is_leaf=lambda x: hasattr(x, "shape"))


def _models(seed, **replace):
    """The JAX model and its seeded params, the port's with them."""
    jm = j_build_model(J_CFG.replace(**replace))
    jp = jm.init_params(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in j_canonical_flat(jp, **IS_ARR).items()}
    cfg = CFG.replace(**replace)
    return jm, jp, build_model(cfg), convert.params_from_reference(flat, cfg)


def test_layout_windows_and_post_norm_leaves_cross_by_key():
    """The reference's group layout and windows; the post-norm leaves
    carried across and back bit for bit with no code of their own."""
    assert ttransformer._group_layout(CFG) == (2, 2)
    assert [ttransformer._sub_window(CFG, j, 2) for j in range(2)] == [8, 0]
    jm, jp, tm, tp = _models(0)
    flat = {k: np.asarray(v) for k, v in j_canonical_flat(jp, **IS_ARR).items()}
    assert {"layers/ln1_post/scale", "layers/ln2_post/scale"} <= set(flat)
    assert set(common.canonical_flat(tm.param_specs())) == set(flat)
    assert tm.param_count() == jm.param_count()
    back = convert.params_to_reference(tp)
    for k, arr in flat.items():
        np.testing.assert_array_equal(back[k].view(np.uint16),
                                      arr.view(np.uint16), err_msg=k)


@pytest.mark.parametrize("attn_scale", [None, 0.1],
                         ids=["head_dim_scale", "attn_scale_0.1"])
def test_forward_logits_match_jax_where_the_window_cuts(attn_scale):
    """S = 20 > window 8: the local layers' window cuts. ``attn_scale``
    0.1 stands for gemma2's (d_model / heads)^-1/2, which
    ``reduced_config`` resets to head_dim^-1/2."""
    jm, jp, tm, tp = _models(3, attn_scale=attn_scale)
    tokens = np.random.default_rng(4).integers(
        0, CFG.vocab_size, (B, 20)).astype(np.int32)
    with jax.disable_jit():
        jlog = jm.forward(jp, {"tokens": jnp.asarray(tokens)})[0]
    tlog = tm.forward(tp, {"tokens": torch.from_numpy(tokens).long()})[0]
    assert tlog.dtype == torch.float32
    assert float(tlog.abs().max()) < CFG.final_logit_softcap
    _check_logits(jlog, tlog)


def test_prefill_cache_and_decode_past_the_window_match_jax():
    """Prefill of 12 tokens, then 8 teacher-forced decode steps to
    position 19, the local layers attending their last 8 keys."""
    jm, jp, tm, tp = _models(5)
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, CFG.vocab_size, (B, P)).astype(np.int32)
    forced = rng.integers(0, CFG.vocab_size, (B, N_NEW)).astype(np.int32)
    with jax.disable_jit():
        jlog, _, jc = jm.forward(jp, {"tokens": jnp.asarray(prompt)},
                                 return_cache=True)
    tlog, _, tc = tm.forward(tp, {"tokens": torch.from_numpy(prompt).long()},
                             return_cache=True)
    _check_logits(jlog, tlog)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]),
                                   **TOL["bfloat16"], err_msg=key)
    jc = jrollout._pad_cache(jc, N_NEW)
    tc = trollout._pad_cache(tc, N_NEW)
    for i in range(N_NEW):
        tok = forced[:, i:i + 1]
        with jax.disable_jit():
            jlog, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(tok)})
        tlog, tc = tm.decode_step(tp, tc,
                                  {"tokens": torch.from_numpy(tok).long()})
        _check_logits(jlog, tlog)
    assert tc["pos"] == P + N_NEW
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), **TOL["bfloat16"])


def test_greedy_rollout_matches_jax_rollout():
    jm, jp, tm, tp = _models(7)
    prompt = np.random.default_rng(9).integers(
        3, CFG.vocab_size, (B, P)).astype(np.int32)
    with jax.disable_jit():
        jtok, jlp, _ = jrollout.rollout(
            jm, jp, jnp.asarray(prompt), jax.random.PRNGKey(0),
            jrollout.RolloutConfig(max_new_tokens=N_NEW, greedy=True))
    ttok, tlp, _ = trollout.rollout(
        tm, tp, torch.from_numpy(prompt).long(), torch.Generator(),
        trollout.RolloutConfig(max_new_tokens=N_NEW, greedy=True))
    jtok, ttok = np.asarray(jtok), ttok.numpy()
    assert ttok.shape == jtok.shape == (B, N_NEW)
    held = _held_tokens(jm, jp, tm, tp, prompt, jtok, ttok)
    assert held >= B * N_NEW // 2, held
    same = ttok == jtok
    np.testing.assert_allclose(tlp.numpy()[same], np.asarray(jlp)[same],
                               rtol=0, atol=5e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [5, 7, 8, 9, 23])
def test_decode_attention_plain_matches_jax_attention_core(pos, dtype):
    """The extended ``ref_decode_attention`` (window 8, softcap 50, a
    scale other than head_dim^-1/2) against the reference's XLA decode
    (``attention_core`` with ``q_positions = pos`` and its ``kv_mask``)
    around the window's edge: at pos 7 the window holds keys 0..7, at 8
    it drops key 0, at 9 keys 0 and 1. A window one key shorter or longer
    moves the output by more than twice the tolerance wherever it changes
    which keys are live."""
    b, t, h, kh, d, window, cap, scale = 2, 24, 4, 2, 16, 8, 50.0, 0.3
    rng = np.random.default_rng(pos)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, h, d), (b, t, kh, d), (b, t, kh, d)))
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    kv_pos = jnp.arange(t)
    jout = jl.attention_core(
        jq[:, None], jk, jv, q_positions=jnp.full((b, 1), pos),
        kv_positions=kv_pos, causal=True, window=window, softcap=cap,
        scale=scale, kv_mask=kv_pos <= pos, impl="xla")[:, 0]
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    out = ref.ref_decode_attention(tq, tk, tv, pos, scale=scale,
                                   window=window, softcap=cap)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL[dtype])
    # one key more or less at the edge is visible at this tolerance
    for moved in (window - 1, window + 1):
        other = ref.ref_decode_attention(tq, tk, tv, pos, scale=scale,
                                         window=moved, softcap=cap)
        if pos >= min(window, moved):
            assert np.abs(_np(other) - _np(jout)).max() > \
                2 * TOL[dtype]["atol"]
