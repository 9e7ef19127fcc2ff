"""The port's vlm (llama-3.2-vision) slice, held against the JAX package on
the CPU.

At ``reduced_config("llama-3.2-vision-90b")``: 10 layers in 2 groups (4
self-attention layers, then a tanh-gated cross-attention layer), d_model
64, 4 query and 2 KV heads of width 16, d_ff 128, vocab 128, vision_seq
9, RMS norms, the SiLU-gated MLP and RoPE at theta 500,000; once at the
real vision_seq of 1,601. The JAX package's seeded parameters are carried
across by ``models/convert.py``; inputs are made with numpy from a seed.

The gates. The reference initialises both gates of a cross layer to 0,
where tanh(0) = 0 hides the cross path: a wrong cross prefill or decode,
wrong cross K/V or a dropped ``vision`` give the same logits as right
ones. Every parity test here therefore writes seeded gates of magnitude
0.5 to 1.5 into the reference's numpy parameters before they are carried
across, so both sides see them; ``test_zero_gates_hide_the_cross_path``
shows the guard works. The patch embeddings are bf16, the same bits on
both sides, at unit scale, and each row's share a component beside their
own noise: the cross keys and values are projected from them without a
norm, so at the reference's ``dummy_batch`` scale of 0.02 the cross path
would move the logits by less than their tolerance; and where the scores
are near uniform the cross attention returns the mean of the values,
which for independent patches shrinks with the square root of their
count (at the real 1,601, to 1/40 of a value).

The JAX side is compiled (``jax.jit``), as for qwen2 in
tests/test_torch_model.py: the family's SiLU MLP and RMS norms round
alike compiled or op by op at this size. Greedy choices are held as in
tests/test_torch_hybrid.py (``_held_tokens``).

Tolerances, as tests/test_torch_whisper.py: bf16 logits at 2^-6 * max
|logit| (four bf16 ulps of the largest logit, tests/test_torch_model.py);
bf16 cache entries and layer outputs rtol = atol = 5e-2, f32 ones 2e-3, as
tests/test_kernels.py; gradients in f32 within 2e-3 of each leaf's
largest magnitude, as tests/test_torch_remat.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.models.vision as jvision
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.core import api as japi
from repro.core.router import Router as JRouter
from repro.models.common import canonical_flat as j_canonical_flat
from repro.models.common import canonical_unflatten as j_canonical_unflatten
from repro.models.registry import build_model as j_build_model
from repro.rl import rollout as jrollout
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import api
from repro_torch.core.router import Router
from repro_torch.kernels import ops as tops
from repro_torch.launch.mesh import DevicePlane
from repro_torch.models import common, convert
from repro_torch.models import vision as tvision
from repro_torch.models.registry import build_model
from repro_torch.rl import rollout as trollout
from test_torch_hybrid import _check_logits, _held_tokens, _np
from test_torch_model import TOL, _both, _close
from test_torch_remat import F32_TOL, REMATS, _f32_embed

torch.set_num_threads(1)

ARCH = "llama-3.2-vision-90b"
CFG = reduced_config(ARCH)
J_CFG = j_reduced_config(ARCH)
B, P, N_NEW = 2, 8, 6
IS_ARR = dict(is_leaf=lambda x: hasattr(x, "shape"))
GATES = ("gate_attn", "gate_mlp")
# the reference's parameter counts: full depth, and the 35-layer cut the
# card serves (7 groups)
FULL_PARAMS, CUT_PARAMS, CUT_LAYERS = 87_666_794_536, 32_049_258_510, 35


def _is_gate(key):
    return key.rsplit("/", 1)[-1] in GATES


def _seeded_gates(flat, seed):
    """``flat`` with every gate set to a seeded value of magnitude 0.5 to
    1.5 and either sign."""
    rng = np.random.default_rng(seed)
    out = dict(flat)
    for k in sorted(k for k in flat if _is_gate(k)):
        mag = rng.uniform(0.5, 1.5, flat[k].shape)
        out[k] = (mag * rng.choice([-1.0, 1.0], flat[k].shape)).astype(
            flat[k].dtype)
    return out


@functools.lru_cache(maxsize=None)
def _jax_model(replace):
    return j_build_model(J_CFG.replace(**dict(replace)))


@functools.lru_cache(maxsize=None)
def _models(seed, replace=(), gates=True):
    """The JAX model and its seeded params (gates seeded nonzero unless
    ``gates`` is False), their canonical numpy leaves, and the port's model
    and params carried across by key. One JAX model a config, so its
    compiled functions serve every seed."""
    replace = tuple((k, v) for k, v in replace if getattr(CFG, k) != v)
    jm = _jax_model(replace)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in j_canonical_flat(jp, **IS_ARR).items()}
    if gates:
        flat = _seeded_gates(flat, seed + 100)
        jp = j_canonical_unflatten(jp, {k: jnp.asarray(v)
                                        for k, v in flat.items()})
    cfg = CFG.replace(**dict(replace))
    return jm, jp, flat, build_model(cfg), \
        convert.params_from_reference(flat, cfg)


def _vision(seed, b, t=CFG.vision_seq, d=CFG.d_model):
    """bf16 patch embeddings, each row's sharing a component beside their
    own noise, as a JAX array and a tensor of the same bits."""
    rng = np.random.default_rng(seed)
    arr = rng.standard_normal((b, t, d)) + rng.standard_normal((b, 1, d))
    j = jnp.asarray(arr, jnp.float32).astype(jnp.bfloat16)
    return j, convert.tensor_from_numpy(np.asarray(j))


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, shape).astype(np.int32)


class _Compiled:
    """A JAX model's forward (as ``_held_tokens`` calls it), prefill with
    a cache and decode step, each compiled once a shape."""

    def __init__(self, jm):
        self.forward = jax.jit(lambda p, batch: jm.forward(p, batch))
        self.prefill = jax.jit(lambda p, tok, vis: jm.forward(
            p, {"tokens": tok, "vision": vis}, return_cache=True))
        self.decode = jax.jit(
            lambda p, c, tok: jm.decode_step(p, c, {"tokens": tok}))


@functools.lru_cache(maxsize=None)
def _compiled(jm):
    return _Compiled(jm)


def _held(jm, jp, tm, tp, prompt, jtok, ttok, jv, tv):
    return _held_tokens(_compiled(jm), jp, tm, tp, prompt, jtok, ttok,
                        {"vision": jv}, {"vision": tv}, op_by_op=False)


# -------------------------------------------------------------- params

def test_param_specs_keys_counts_and_round_trip():
    """The reduced tree's keys and shapes, the reference's counts at full
    depth and at the 35-layer cut (whose bytes are 2 per bf16 parameter
    and 4 for each of the 14 f32 gates), a bit-exact round trip by
    canonical key, and the cache specs (the reference's but for the
    host-int ``pos``)."""
    jm, _, flat, tm, tp = _models(0)
    specs = common.canonical_flat(tm.param_specs())
    assert set(specs) == set(flat)
    for k, s in specs.items():
        assert s.shape == flat[k].shape, k
        assert s.dtype == (torch.float32 if _is_gate(k) else
                           torch.bfloat16), k
    assert specs["self_layers/attn/wq"].shape == (2, 4, 64, 4, 16)
    assert specs["cross_layers/gate_attn"].shape == (2,)
    assert specs["cross_layers/gate_attn"].init == "zeros"
    assert tm.param_count() == jm.param_count()
    for layers, want in ((None, FULL_PARAMS), (CUT_LAYERS, CUT_PARAMS)):
        cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
        if layers:
            cfg, jcfg = (c.replace(num_layers=layers) for c in (cfg, jcfg))
        m = build_model(cfg)
        assert m.param_count() == j_build_model(jcfg).param_count() == want
        if layers:
            nbytes = sum(int(np.prod(s.shape)) * s.dtype.itemsize
                         for s in common.canonical_flat(
                             m.param_specs()).values())
            assert nbytes == 2 * want + 28
    back = convert.params_to_reference(tp)
    for k, arr in flat.items():
        assert back[k].dtype == arr.dtype and back[k].shape == arr.shape, k
        np.testing.assert_array_equal(back[k].view(np.uint8),
                                      arr.view(np.uint8), err_msg=k)
    cspecs, jspecs = tm.cache_specs(3, 40), jm.cache_specs(3, 40)
    assert set(cspecs) == set(jspecs) - {"pos"}
    for k, s in cspecs.items():
        assert s.shape == tuple(jspecs[k].shape), k
    assert cspecs["k"].shape == (2, 4, 3, 40, 2, 16)
    assert cspecs["cross_k"].shape == (2, 3, 9, 2, 16)


# ---------------------------------------------------------- cross layer

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_layer_prefill_and_decode_match_jax(dtype):
    """``cross_layer_apply`` against the reference's ``_cross_layer`` with
    nonzero gates: the prefill (K1's function, non-causal over the vision
    keys, nothing rotated) with its cross K/V, then one decode token over
    them (K2's, q alone projected). At ``attn_scale`` 0.1 the prefill
    attends at 0.1 and the decode at head_dim^-1/2, on both sides."""
    cfg, jcfg = (c.replace(attn_scale=0.1) for c in (CFG, J_CFG))
    rng = np.random.default_rng(1)
    specs = common.canonical_flat(tvision.cross_layer_param_specs(cfg))
    # weights at the init's fan-in scale, norm scales at 0.1: outputs of
    # unit size, where bf16's rounding stays inside the tolerance
    pairs = {k: _both(rng.uniform(0.5, 1.5) if _is_gate(k) else
                      rng.standard_normal(s.shape)
                      * (0.1 if len(s.shape) == 1 else
                         float(np.prod(s.shape[:-1])) ** -0.5),
                      "float32" if _is_gate(k) else dtype)
             for k, s in specs.items()}
    tmpl = tvision.cross_layer_param_specs(cfg)
    jp = common.canonical_unflatten(tmpl, {k: v[0] for k, v in pairs.items()})
    tp = common.canonical_unflatten(tmpl, {k: v[1] for k, v in pairs.items()})
    (jx, tx), (jv, tv) = (_both(rng.standard_normal((2, n, 64)), dtype)
                          for n in (5, 9))
    pos = np.broadcast_to(np.arange(5), (2, 5)).astype(np.int32)
    vis_pos = jnp.broadcast_to(jnp.arange(9), (2, 9))
    jout, jkv = jvision._cross_layer(jp, jcfg, jx, jv, jnp.asarray(pos),
                                     vis_pos, None)
    tout, tkv = tvision.cross_layer_apply(tp, cfg, tx, tv,
                                          torch.from_numpy(pos))
    assert tout.dtype == tx.dtype
    _close(jout, tout, dtype)
    for key in ("k", "v"):
        assert tuple(tkv[key].shape) == (2, 9, 2, 16)
        _close(jkv[key], tkv[key], dtype)
    (jx1, tx1) = _both(rng.standard_normal((2, 1, 64)), dtype)
    pos1 = np.full((2, 1), 5, np.int32)
    jout, _ = jvision._cross_layer(jp, jcfg, jx1, None, jnp.asarray(pos1),
                                   vis_pos, None, cross_kv=jkv)
    tout, kept = tvision.cross_layer_apply(tp, cfg, tx1, None,
                                           torch.from_numpy(pos1),
                                           cross_kv=tkv)
    assert kept is tkv
    _close(jout, tout, dtype)


# ------------------------------------------------------------- model

def _prefill(seed, replace=(), p=P, t_vis=CFG.vision_seq):
    """Both sides' prefill of seeded tokens over seeded patch
    embeddings."""
    jm, jp, _, tm, tp = _models(seed, replace)
    jv, tv = _vision(seed + 1, B, t_vis)
    prompt = _tokens(seed + 2, B, p)
    jlog, _, jc = _compiled(jm).prefill(jp, jnp.asarray(prompt), jv)
    tlog, aux, tc = tm.forward(tp, {"tokens": torch.from_numpy(prompt).long(),
                                    "vision": tv}, return_cache=True)
    assert float(aux) == 0.0
    return (jm, jp, jlog, jc), (tm, tp, tlog, tc)


def _check_cache(jc, tc, p):
    assert set(tc) == set(jc) and tc["pos"] == p
    for key in ("k", "v", "cross_k", "cross_v"):
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        assert tc[key].dtype == torch.bfloat16, key
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]),
                                   **TOL["bfloat16"], err_msg=key)


def _decode_both(jm, jp, jc, tm, tp, tc, forced):
    """Teacher-forced decode steps on both sides; every step's logits
    held. The cross K/V are read, never written."""
    cross = {k: (tc[k], tc[k].clone()) for k in ("cross_k", "cross_v")}
    dec = _compiled(jm).decode
    for i in range(forced.shape[1]):
        tok = forced[:, i:i + 1]
        pos = tc["pos"]
        jlog, jc = dec(jp, jc, jnp.asarray(tok))
        tlog, tc = tm.decode_step(tp, tc,
                                  {"tokens": torch.from_numpy(tok).long()})
        _check_logits(jlog, tlog)
        assert tc["pos"] == pos + 1
    for k, (t, kept) in cross.items():
        assert tc[k] is t and torch.equal(t, kept), k
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]),
                                   **TOL["bfloat16"], err_msg=key)
    return tc


@pytest.mark.parametrize("attn_scale", [None, 0.1],
                         ids=["head_dim_scale", "attn_scale_0.1"])
def test_prefill_cache_and_teacher_forced_decode_match_jax(attn_scale):
    """The prefill's logits and all four cache entries; ``_pad_cache``
    grows the 6-D self cache's T axis on both sides and leaves the cross
    K/V at vision_seq; each layer's cache slice is contiguous and 16-byte
    aligned, as K2 needs; then 4 teacher-forced decode steps. With
    ``attn_scale`` 0.1 the prefill attends at 0.1 (self and cross) and the
    cross decode at head_dim^-1/2 (``repro/models/vision.py:75``)."""
    replace = (("attn_scale", attn_scale),)
    (jm, jp, jlog, jc), (tm, tp, tlog, tc) = _prefill(3, replace)
    _check_logits(jlog, tlog)
    _check_cache(jc, tc, P)
    jc, tc = jrollout._pad_cache(jc, N_NEW), trollout._pad_cache(tc, N_NEW)
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape) == \
        (2, 4, B, P + N_NEW, 2, 16)
    assert tuple(tc["cross_k"].shape) == tuple(jc["cross_k"].shape) == \
        (2, B, 9, 2, 16)
    for g in range(2):
        views = [tc["cross_k"][g], tc["cross_v"][g]] + \
            [tc[key][g][j] for key in ("k", "v") for j in range(4)]
        for view in views:
            assert view.is_contiguous() and view.data_ptr() % 16 == 0
    _decode_both(jm, jp, jc, tm, tp, tc, _tokens(4, B, 4))


def test_decode_matches_teacher_forced_forward_in_the_port():
    """The port alone: the prefill's last logits and each decode step's
    against a forward over the whole sequence."""
    _, _, _, tm, tp = _models(5)
    _, tv = _vision(6, B)
    seq = torch.from_numpy(_tokens(7, B, P + N_NEW)).long()
    full = tm.forward(tp, {"tokens": seq, "vision": tv})[0]
    logits, _, cache = tm.forward(tp, {"tokens": seq[:, :P], "vision": tv},
                                  return_cache=True)
    steps = [logits[:, -1]]
    cache = trollout._pad_cache(cache, N_NEW)
    for i in range(P, P + N_NEW):
        logits, cache = tm.decode_step(tp, cache, {"tokens": seq[:, i:i + 1]})
        steps.append(logits[:, 0])
    _check_logits(full[:, P - 1:], torch.stack(steps, 1))


def test_zero_gates_hide_the_cross_path():
    """The guard the nonzero gates are for. At the reference's zero gates
    the logits do not depend on ``vision`` in either package (bit for
    bit); at the seeded gates they do, in both, by more than the logit
    tolerance, so a parity test there fails if the cross path is cut
    off."""
    prompt = _tokens(20, B, P)
    visions = [_vision(seed, B) for seed in (21, 22)]
    for gates in (False, True):
        jm, jp, _, tm, tp = _models(9, gates=gates)
        jout = [np.asarray(_compiled(jm).forward(
            jp, {"tokens": jnp.asarray(prompt), "vision": jv})[0])
            for jv, _ in visions]
        tout = [tm.forward(tp, {"tokens": torch.from_numpy(prompt).long(),
                                "vision": tv})[0].numpy()
                for _, tv in visions]
        for a, b in (jout, tout):
            if gates:
                tol = 2.0 ** -6 * np.abs(a).max()
                assert np.abs(a - b).max() > tol, (np.abs(a - b).max(), tol)
            else:
                np.testing.assert_array_equal(a, b)


def test_real_vision_seq_at_reduced_width():
    """vision_seq 1,601 (one tile of 40 x 40 patches and a class token):
    the prefill's logits and cache, the (G, B, 1601, K, D) cross K/V, and
    2 decode steps over all 1,601 keys. ``attn_q_chunk`` 0: the reference
    attends in one block (the same function)."""
    replace = (("vision_seq", 1601), ("attn_q_chunk", 0))
    (jm, jp, jlog, jc), (tm, tp, tlog, tc) = _prefill(8, replace,
                                                      t_vis=1601)
    _check_logits(jlog, tlog)
    _check_cache(jc, tc, P)
    assert tuple(tc["cross_k"].shape) == (2, B, 1601, 2, 16)
    jc, tc = jrollout._pad_cache(jc, 2), trollout._pad_cache(tc, 2)
    _decode_both(jm, jp, jc, tm, tp, tc, _tokens(9, B, 2))


def test_greedy_rollout_with_extra_inputs_matches_jax_rollout():
    jm, jp, _, tm, tp = _models(10)
    jv, tv = _vision(11, B)
    prompt = np.random.default_rng(12).integers(
        3, CFG.vocab_size, (B, P)).astype(np.int32)
    jtok, jlp, _ = jrollout.rollout(
        jm, jp, jnp.asarray(prompt), jax.random.PRNGKey(0),
        jrollout.RolloutConfig(max_new_tokens=N_NEW, greedy=True),
        extra_inputs={"vision": jv})
    ttok, tlp, _ = trollout.rollout(
        tm, tp, torch.from_numpy(prompt).long(), torch.Generator(),
        trollout.RolloutConfig(max_new_tokens=N_NEW, greedy=True),
        extra_inputs={"vision": tv})
    jtok, ttok = np.asarray(jtok), ttok.numpy()
    assert ttok.shape == jtok.shape == (B, N_NEW)
    held = _held(jm, jp, tm, tp, prompt, jtok, ttok, jv, tv)
    assert held >= B * N_NEW // 2, held
    same = ttok == jtok
    np.testing.assert_allclose(tlp.numpy()[same], np.asarray(jlp)[same],
                               rtol=0, atol=5e-2)


def test_generate_attends_only_through_the_kernel_wrappers(monkeypatch):
    """A rollout with SDPA and flex_attention patched to raise: every
    attention is a call of K1's or K2's wrapper, exactly num_layers K1 (8
    self-attention prefills, causal, and 2 cross prefills, non-causal over
    all vision_seq keys) and num_layers K2 a decode step (the 2 cross
    layers at pos vision_seq - 1, the 8 self layers at the step's
    position)."""
    from torch.nn.attention import flex_attention as flex

    def refuse(*a, **k):
        raise AssertionError("a library attention on the vision path")

    monkeypatch.setattr(F, "scaled_dot_product_attention", refuse)
    monkeypatch.setattr(flex, "flex_attention", refuse)
    k1, k2 = [], []
    flash, decode = tops.flash_attention, tops.decode_attention

    def counted_flash(q, k, v, **kw):
        k1.append((kw["causal"], q.shape[1], k.shape[1]))
        return flash(q, k, v, **kw)

    def counted_decode(q, kc, vc, pos, **kw):
        k2.append((pos, kc.shape[1]))
        return decode(q, kc, vc, pos, **kw)

    monkeypatch.setattr(tops, "flash_attention", counted_flash)
    monkeypatch.setattr(tops, "decode_attention", counted_decode)
    _, _, _, tm, tp = _models(0)
    _, tv = _vision(13, B)
    prompt = torch.from_numpy(_tokens(14, B, P)).long()
    trollout.rollout(tm, tp, prompt, torch.Generator().manual_seed(0),
                     trollout.RolloutConfig(max_new_tokens=N_NEW),
                     extra_inputs={"vision": tv})
    t_vis, (groups, per_group) = CFG.vision_seq, tvision._layout(CFG)
    n_self = groups * per_group
    assert sorted(k1) == sorted([(True, P, P)] * n_self
                                + [(False, P, t_vis)] * groups)
    assert len(k2) == CFG.num_layers * N_NEW
    assert k2.count((t_vis - 1, t_vis)) == groups * N_NEW
    assert sorted(pos for pos, t in k2 if t == P + N_NEW) == sorted(
        P + i for i in range(N_NEW) for _ in range(n_self))


# ------------------------------------------------------------- remat

def _f32_inputs(seed=0):
    """The JAX model with its seeded params in f32 (gates seeded nonzero),
    their canonical leaves, tokens, f32 patch embeddings and a logits
    cotangent."""
    jm, jp, flat, _, _ = _models(seed)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG.vocab_size, (B, P)).astype(np.int32)
    vis = rng.standard_normal((B, CFG.vision_seq, CFG.d_model)).astype(
        np.float32)
    ct = rng.standard_normal((B, P, CFG.vocab_size)).astype(np.float32)
    return jm, jp, flat, tokens, vis, ct


def _port_grads(flat, tokens, vis, ct, remat):
    cfg = CFG.replace(remat=remat)
    params = convert.params_from_reference(flat, cfg)
    leaves = {k: p.requires_grad_() for k, p in
              common.canonical_flat(params).items()}
    logits, aux = build_model(cfg).forward(
        common.canonical_unflatten(params, leaves),
        {"tokens": torch.from_numpy(tokens).long(),
         "vision": torch.from_numpy(vis)})
    ((logits * torch.from_numpy(ct)).sum() + aux).backward()
    return {k: p.grad for k, p in leaves.items()}


@pytest.fixture
def f32_vision(monkeypatch):
    for mod in (jvision, tvision):
        monkeypatch.setattr(mod, "embed_apply", _f32_embed)


def test_grads_equal_under_every_remat_and_match_jax_vjp(f32_vision):
    """In f32 with nonzero gates: the gradients of ``sum(logits * ct)``
    under "none", "full" and "dots" against ``jax.vjp`` of the reference's
    forward (each group under ``jax.checkpoint``), every leaf, the gates
    and the cross layers' projections of ``vision`` included."""
    jm, jp, flat, tokens, vis, ct = _f32_inputs()

    def fwd(p):
        return jm.forward(p, {"tokens": jnp.asarray(tokens),
                              "vision": jnp.asarray(vis)})[:2]

    @jax.jit
    def grads(p):
        vjp = jax.vjp(fwd, p)[1]
        return vjp((jnp.asarray(ct), jnp.ones((), jnp.float32)))[0]

    jgrads = grads(jp)
    want = {k: np.asarray(v) for k, v in
            j_canonical_flat(jgrads, **IS_ARR).items()}
    got = {r: _port_grads(flat, tokens, vis, ct, r) for r in REMATS}
    for remat, grads in got.items():
        assert grads.keys() == want.keys(), remat
        for k, g in grads.items():
            assert g is not None and g.dtype == torch.float32, (remat, k)
            bound = F32_TOL * max(float(np.abs(want[k]).max()), 1e-30)
            err = float(np.abs(g.numpy() - want[k]).max())
            assert err <= bound, (remat, k, err, bound)
    assert all(float(np.abs(want[f"cross_layers/{g}"]).min()) > 0
               for g in GATES)


@pytest.mark.parametrize("remat", REMATS + ("no_grad",))
def test_each_group_runs_twice_under_remat_once_without(remat, monkeypatch,
                                                        f32_vision):
    """A forward and backward runs each group (4 self layers and the cross
    layer) twice under "full" and "dots" (the recomputation), once under
    "none"; a forward under ``torch.no_grad()`` (at the default "full")
    once."""
    _, _, flat, tokens, vis, ct = _f32_inputs()
    calls = {"group": 0, "self": 0, "cross": 0}
    for name, key in (("group_apply", "group"),
                      ("cross_layer_apply", "cross")):
        fn = getattr(tvision, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tvision, name, counted)
    layer_apply = tvision.tf.layer_apply

    def counted_layer(*a, **kw):
        calls["self"] += 1
        return layer_apply(*a, **kw)

    monkeypatch.setattr(tvision.tf, "layer_apply", counted_layer)
    if remat == "no_grad":
        params = convert.params_from_reference(flat, CFG)
        with torch.no_grad():
            build_model(CFG).forward(
                params, {"tokens": torch.from_numpy(tokens).long(),
                         "vision": torch.from_numpy(vis)})
    else:
        _port_grads(flat, tokens, vis, ct, remat)
    times = 2 if remat in ("full", "dots") else 1
    groups, per_group = tvision._layout(CFG)
    assert calls == {"group": times * groups,
                     "self": times * groups * per_group,
                     "cross": times * groups}


# ------------------------------------------------- serving: two jobs, greedy

ORDER = ("A", "B", "A")
# the reduced config as a deployment's overrides of the full one
OVERRIDES = tuple((f.name, getattr(CFG, f.name))
                  for f in dataclasses.fields(CFG)
                  if getattr(CFG, f.name) != getattr(get_config(ARCH), f.name))


def _spec(mod, job):
    return mod.DeploymentSpec(deployment_id=f"vision-{job}", job_id=job,
                              model_name=ARCH, role="rollout",
                              overrides=OVERRIDES)


def test_port_router_serves_vision_like_jax_router_on_two_jobs():
    """Greedy GENERATEs with ``extra_inputs={"vision": ...}`` of two jobs
    on one group, jobs A, B, A, each round a context switch, through both
    packages' Routers. After INIT each job's gates are set to seeded
    nonzero values, on the JAX side in its StateManager's entries, and the
    port's WPGs are given the same parameters, converted; tokens held as
    in the greedy rollout test."""
    prompt = np.random.default_rng(15).integers(
        3, CFG.vocab_size, (B, P)).astype(np.int32)
    jv, tv = _vision(16, B)
    jrouter = JRouter()
    jdeps = {job: jrouter.deploy(_spec(japi, job), group_id=0) for job in "AB"}
    for seed, dep in enumerate(jdeps.values()):
        dep.init(seed=seed)
    jrouter.drain()
    flat, sm = {}, jrouter.state_managers[0]
    for i, (job, dep) in enumerate(jdeps.items()):
        flat[job] = _seeded_gates({k: np.asarray(v) for k, v in
                                   j_canonical_flat(dep.wpg.params(),
                                                    **IS_ARR).items()}, i)
        for k in GATES:
            e = sm.entries[f"{dep.wpg.job_prefix}/params/cross_layers/{k}"]
            val = flat[job][f"cross_layers/{k}"]
            e.ref = val if isinstance(e.ref, np.ndarray) else jnp.asarray(val)
    jouts = []
    for job in ORDER:
        fut = jdeps[job].generate(jnp.asarray(prompt), max_new_tokens=N_NEW,
                                  temperature=0.0,
                                  extra_inputs={"vision": jv})
        jrouter.drain()
        jouts.append(np.asarray(fut.wait()["tokens"]))

    router = Router(device_plane=DevicePlane(devices=[torch.device("cpu")]))
    deps = {job: router.deploy(_spec(api, job), group_id=0) for job in "AB"}
    with router:
        for job, dep in deps.items():
            assert dep.wpg.cfg == CFG
            params = convert.params_from_reference(flat[job], dep.wpg.cfg)
            dep.call(api.Op.INIT, params=params).wait(timeout=60)
        outs = [deps[job].generate(prompt, max_new_tokens=N_NEW,
                                   temperature=0.0,
                                   extra_inputs={"vision": tv}
                                   ).wait(timeout=120)
                for job in ORDER]

    held = 0
    for job, jtok, out in zip(ORDER, jouts, outs):
        ttok = out["tokens"].numpy()
        assert ttok.shape == jtok.shape == (B, N_NEW)
        assert np.isfinite(out["logprobs"].numpy()).all()
        wpg = jdeps[job].wpg
        jp = wpg.params()
        assert float(np.abs(np.asarray(
            jp["cross_layers"]["gate_attn"])).min()) >= 0.5
        held += _held(_models(0)[0], jp, build_model(CFG),
                      convert.params_from_reference(flat[job], CFG), prompt,
                      jtok, ttok, jv, tv)
    assert held >= len(ORDER) * B * N_NEW // 2, held
    assert [s["to_job"] for s in router.switch_log[-len(ORDER):]] == \
        list(ORDER)
    assert sum(s["t_offload"] > 0 for s in router.switch_log) >= 2
