"""The port's audio (whisper) slice, held against the JAX package on the CPU.

At ``reduced_config("whisper-large-v3")``: 2 encoder and 2 decoder layers,
d_model 64, 4 heads of width 16 (MHA), d_ff 128, vocab 128, encoder_seq
12, layer norms with a bias, the plain biased tanh-GELU MLP, sinusoidal
positions and no RoPE; once at the real encoder_seq of 1,500. The JAX
package's seeded parameters are carried across by ``models/convert.py``;
inputs are made with numpy from a seed, and the frames are bf16 at scale
0.02 (the reference's ``dummy_batch``), the same bits on both sides.

The JAX side runs op by op (``jax.disable_jit``), as in
``tests/test_torch_hybrid.py``: its tanh GELU is a chain of bf16 ops, each
rounded, where ``F.gelu(approximate="tanh")`` rounds once, and compiled,
XLA skips roundings of its own. Greedy choices are held as there
(``_held_tokens``).

Tolerances: bf16 logits at 2^-6 * max |logit| (four bf16 ulps of the
largest logit, tests/test_torch_model.py); bf16 cache entries, encoder
outputs and layer outputs rtol = atol = 5e-2, f32 ones 2e-3, as
tests/test_kernels.py; the f32 sinusoid 2^-12: the two libraries' f32
``exp`` part by one ulp on some frequencies, and an angle of up to 1,499
rad then rounds one f32 step (2^-13) apart.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.core import api as japi
from repro.core.router import Router as JRouter
from repro.models import layers as jl
from repro.models import whisper as jwhisper
from repro.models.common import canonical_flat as j_canonical_flat
from repro.models.registry import build_model as j_build_model
from repro.rl import rollout as jrollout
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import api
from repro_torch.core.router import Router
from repro_torch.kernels import ops as tops
from repro_torch.launch.mesh import DevicePlane
from repro_torch.models import common, convert
from repro_torch.models import layers as tl
from repro_torch.models import whisper as twhisper
from repro_torch.models.registry import build_model
from repro_torch.rl import rollout as trollout
from test_torch_hybrid import _check_logits, _held_tokens, _np
from test_torch_model import TOL, _both, _close

torch.set_num_threads(1)

ARCH = "whisper-large-v3"
CFG = reduced_config(ARCH)
J_CFG = j_reduced_config(ARCH)
B, P, N_NEW = 2, 8, 6
IS_ARR = dict(is_leaf=lambda x: hasattr(x, "shape"))


@functools.lru_cache(maxsize=None)
def _models(seed, replace=()):
    """The JAX model and its seeded params, their canonical numpy leaves,
    and the port's model and params carried across by key."""
    jm = j_build_model(J_CFG.replace(**dict(replace)))
    jp = jm.init_params(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in j_canonical_flat(jp, **IS_ARR).items()}
    cfg = CFG.replace(**dict(replace))
    return jm, jp, flat, build_model(cfg), \
        convert.params_from_reference(flat, cfg)


def _frames(seed, b, t, d=CFG.d_model):
    """bf16 frames at scale 0.02, as a JAX array and a tensor of the same
    bits."""
    arr = np.random.default_rng(seed).standard_normal((b, t, d)) * 0.02
    j = jnp.asarray(arr, jnp.float32).astype(jnp.bfloat16)
    return j, convert.tensor_from_numpy(np.asarray(j))


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, shape).astype(np.int32)


# ------------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)) * 3 + 1
    scale, bias = 1 + rng.standard_normal(64) * 0.3, rng.standard_normal(64)
    (jx, tx), (js, ts), (jb, tb) = (_both(a, dtype) for a in (x, scale, bias))
    out = tl.layer_norm(tx, ts, tb, 1e-5)
    assert out.dtype == tx.dtype
    _close(jl.layer_norm(jx, js, jb, 1e-5), out, dtype)
    # the config's branch, and its specs: scale ones, bias zeros
    specs = tl.norm_param_specs(CFG)
    assert {k: s.init for k, s in specs.items()} == {"scale": "ones",
                                                     "bias": "zeros"}
    _close(jl.apply_norm({"scale": js, "bias": jb}, jx, J_CFG),
           tl.apply_norm({"scale": ts, "bias": tb}, tx, CFG), dtype)


@pytest.mark.parametrize("d_model", [64, 1280])
def test_sinusoidal_positions_match_jax(d_model):
    """Positions 0..1499, whisper's encoder_seq, at both widths, within two
    f32 steps of the largest angle (module docstring)."""
    pos = np.stack([np.arange(1500), np.arange(1500)[::-1]]).astype(np.int32)
    out = tl.sinusoidal_positions(torch.from_numpy(pos), d_model)
    assert out.dtype == torch.float32 and out.shape == (2, 1500, d_model)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jl.sinusoidal_positions(jnp.asarray(pos),
                                                        d_model)),
        rtol=0, atol=2.0 ** -12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_biased_mlp_matches_jax(dtype):
    """act(x W_i + b_i) W_o + b_o with non-zero biases, each added to the
    product in its dtype; the JAX side op by op."""
    rng = np.random.default_rng(1)
    specs = common.canonical_flat(tl.mlp_param_specs(CFG, CFG.d_ff))
    assert set(specs) == {"bi", "bo", "wi", "wo"}
    pairs = {k: _both(rng.standard_normal(s.shape) * 0.3, dtype)
             for k, s in specs.items()}
    jx, tx = _both(rng.standard_normal((2, 7, CFG.d_model)), dtype)
    with jax.disable_jit():
        expect = jl.mlp_apply({k: v[0] for k, v in pairs.items()}, J_CFG, jx)
    got = tl.mlp_apply({k: v[1] for k, v in pairs.items()}, CFG, tx)
    assert got.dtype == tx.dtype
    _close(expect, got, dtype)


def test_cross_attention_projects_keys_from_kv_x_unrotated():
    """``attn_apply`` with ``kv_x``: q from x, k and v from kv_x, keys
    never rotated, against the reference's (a RoPE config, so the rotation
    would show)."""
    cfg, jcfg = CFG.replace(rope_theta=1e4), J_CFG.replace(rope_theta=1e4)
    rng = np.random.default_rng(2)
    specs = common.canonical_flat(tl.attn_param_specs(cfg))
    pairs = {k: _both(rng.standard_normal(s.shape) * 0.3, "float32")
             for k, s in specs.items()}
    (jx, tx), (jkv, tkv) = (_both(rng.standard_normal((2, n, 64)), "float32")
                            for n in (5, 9))
    pos = np.broadcast_to(np.arange(5) + 3, (2, 5)).astype(np.int32)
    out, kv = tl.attn_apply({k: v[1] for k, v in pairs.items()}, cfg, tx,
                            positions=torch.from_numpy(pos), kv_x=tkv,
                            causal=False)
    jout, jkv_out = jl.attn_apply(
        {k: v[0] for k, v in pairs.items()}, jcfg, jx,
        positions=jnp.asarray(pos), kv_x=jkv,
        kv_positions=jnp.broadcast_to(jnp.arange(9), (2, 9)), causal=False)
    _close(jout, out, "float32")
    for key in ("k", "v"):
        assert tuple(kv[key].shape) == (2, 9, 4, 16)
        _close(jkv_out[key], kv[key], "float32")


# -------------------------------------------------------------------- model

def test_param_count_cache_specs_and_round_trip():
    """The full config's 1,535,219,200 parameters (the reference's count);
    the reduced tree crosses both ways by canonical key, bit for bit; the
    cache specs are the reference's but for the host-int ``pos``."""
    full = build_model(get_config(ARCH))
    assert full.param_count() == j_build_model(
        j_get_config(ARCH)).param_count() == 1_535_219_200
    _, _, flat, tm, tp = _models(0)
    assert set(common.canonical_flat(tm.param_specs())) == set(flat)
    assert {"enc_layers/attn/wq", "enc_ln_f/bias", "layers/cross_attn/wk",
            "layers/ln3/scale", "layers/mlp/bi"} <= set(flat)
    back = convert.params_to_reference(tp)
    for k, arr in flat.items():
        assert back[k].dtype == arr.dtype and back[k].shape == arr.shape, k
        np.testing.assert_array_equal(back[k].view(np.uint16),
                                      arr.view(np.uint16), err_msg=k)
    specs, jspecs = tm.cache_specs(3, 40), _models(0)[0].cache_specs(3, 40)
    assert set(specs) == set(jspecs) - {"pos"}
    for k, s in specs.items():
        assert s.shape == tuple(jspecs[k].shape), k
    a = tm.init_params(torch.Generator().manual_seed(3))
    b = tm.init_params(torch.Generator().manual_seed(3))
    for k, t in common.canonical_flat(a).items():
        assert torch.equal(t, common.canonical_flat(b)[k]), k


def test_encode_matches_jax():
    jm, jp, _, tm, tp = _models(1)
    jf, tf = _frames(2, B, CFG.encoder_seq)
    with jax.disable_jit():
        expect = jwhisper.encode(jp, J_CFG, jf)
    got = twhisper.encode(tp, CFG, tf)
    assert got.dtype == torch.bfloat16
    _close(expect, got, "bfloat16")


def _prefill(seed, replace=(), p=P, t_enc=CFG.encoder_seq):
    """Both sides' prefill of seeded tokens over seeded frames."""
    jm, jp, _, tm, tp = _models(seed, replace)
    jf, tf = _frames(seed + 1, B, t_enc)
    prompt = _tokens(seed + 2, B, p)
    with jax.disable_jit():
        jlog, _, jc = jm.forward(jp, {"tokens": jnp.asarray(prompt),
                                      "frames": jf}, return_cache=True)
    tlog, aux, tc = tm.forward(tp, {"tokens": torch.from_numpy(prompt).long(),
                                    "frames": tf}, return_cache=True)
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
    for i in range(forced.shape[1]):
        tok = forced[:, i:i + 1]
        pos = tc["pos"]
        with jax.disable_jit():
            jlog, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(tok)})
        tlog, tc = tm.decode_step(tp, tc,
                                  {"tokens": torch.from_numpy(tok).long()})
        _check_logits(jlog, tlog)
        assert tc["pos"] == pos + 1
    for k, (t, kept) in cross.items():
        assert tc[k] is t and torch.equal(t, kept), k
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]),
                               **TOL["bfloat16"])
    return tc


@pytest.mark.parametrize("attn_scale", [None, 0.1],
                         ids=["head_dim_scale", "attn_scale_0.1"])
def test_prefill_cache_and_teacher_forced_decode_match_jax(attn_scale):
    """The prefill's logits and all four cache entries, then 4
    teacher-forced decode steps. With ``attn_scale`` 0.1 the reference's
    prefill attends at 0.1 and its cross-attention decode at head_dim^-1/2
    (``repro/models/whisper.py:108``); the port does the same."""
    replace = (("attn_scale", attn_scale),)
    (jm, jp, jlog, jc), (tm, tp, tlog, tc) = _prefill(3, replace)
    _check_logits(jlog, tlog)
    _check_cache(jc, tc, P)
    for i in range(CFG.num_layers):          # K2's per-layer views
        for key in ("cross_k", "cross_v"):
            view = tc[key][i]
            assert view.is_contiguous() and view.data_ptr() % 16 == 0
    # room for N_NEW tokens, the rollouts' cache (one shape for JAX to
    # compile its ops at), 4 of them decoded
    jc, tc = jrollout._pad_cache(jc, N_NEW), trollout._pad_cache(tc, N_NEW)
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape) == \
        (CFG.num_layers, B, P + N_NEW, 4, 16)
    assert tuple(tc["cross_k"].shape) == (CFG.num_layers, B, 12, 4, 16)
    _decode_both(jm, jp, jc, tm, tp, tc, _tokens(4, B, 4))


def test_decode_matches_teacher_forced_forward_in_the_port():
    """The port alone: the prefill's last logits and each decode step's
    against a forward over the whole sequence."""
    _, _, _, tm, tp = _models(5)
    _, tf = _frames(6, B, CFG.encoder_seq)
    seq = torch.from_numpy(_tokens(7, B, P + N_NEW)).long()
    full = tm.forward(tp, {"tokens": seq, "frames": tf})[0]
    logits, _, cache = tm.forward(tp, {"tokens": seq[:, :P], "frames": tf},
                                  return_cache=True)
    steps = [logits[:, -1]]
    cache = trollout._pad_cache(cache, N_NEW)
    for i in range(P, P + N_NEW):
        logits, cache = tm.decode_step(tp, cache, {"tokens": seq[:, i:i + 1]})
        steps.append(logits[:, 0])
    _check_logits(full[:, P - 1:], torch.stack(steps, 1))


def test_real_encoder_seq_at_reduced_width():
    """encoder_seq 1,500 (whisper's 30 s of audio): the prefill's logits
    and cache, the (L, B, 1500, K, D) cross K/V, and 2 decode steps over
    all 1,500 encoder keys. ``attn_q_chunk`` 0: the reference's encoder
    attends in one block, not in 47 query blocks of 32 run op by op (the
    same function; only the backward, not run here, would chunk)."""
    replace = (("encoder_seq", 1500), ("attn_q_chunk", 0))
    (jm, jp, jlog, jc), (tm, tp, tlog, tc) = _prefill(8, replace,
                                                      t_enc=1500)
    _check_logits(jlog, tlog)
    _check_cache(jc, tc, P)
    assert tuple(tc["cross_k"].shape) == (CFG.num_layers, B, 1500, 4, 16)
    jc, tc = jrollout._pad_cache(jc, 2), trollout._pad_cache(tc, 2)
    _decode_both(jm, jp, jc, tm, tp, tc, _tokens(9, B, 2))


def test_greedy_rollout_with_extra_inputs_matches_jax_rollout():
    jm, jp, _, tm, tp = _models(10)
    jf, tf = _frames(11, B, CFG.encoder_seq)
    prompt = np.random.default_rng(12).integers(
        3, CFG.vocab_size, (B, P)).astype(np.int32)
    with jax.disable_jit():
        jtok, jlp, _ = jrollout.rollout(
            jm, jp, jnp.asarray(prompt), jax.random.PRNGKey(0),
            jrollout.RolloutConfig(max_new_tokens=N_NEW, greedy=True),
            extra_inputs={"frames": jf})
    ttok, tlp, _ = trollout.rollout(
        tm, tp, torch.from_numpy(prompt).long(), torch.Generator(),
        trollout.RolloutConfig(max_new_tokens=N_NEW, greedy=True),
        extra_inputs={"frames": tf})
    jtok, ttok = np.asarray(jtok), ttok.numpy()
    assert ttok.shape == jtok.shape == (B, N_NEW)
    held = _held_tokens(jm, jp, tm, tp, prompt, jtok, ttok,
                        {"frames": jf}, {"frames": tf})
    assert held >= B * N_NEW // 2, held
    same = ttok == jtok
    np.testing.assert_allclose(tlp.numpy()[same], np.asarray(jlp)[same],
                               rtol=0, atol=5e-2)


def test_generate_attends_only_through_the_kernel_wrappers(monkeypatch):
    """A rollout with SDPA and flex_attention patched to raise: every
    attention is a call of K1's or K2's wrapper, exactly encoder_layers + 2
    * num_layers K1 (the encoder and the cross-attention non-causal over
    all encoder_seq keys, the decoder's self-attention causal) and 2 *
    num_layers K2 a decode step (the cross-attention at pos encoder_seq -
    1, the self-attention at the step's position)."""
    from torch.nn.attention import flex_attention as flex

    def refuse(*a, **k):
        raise AssertionError("a library attention on the whisper path")

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
    _, tf = _frames(13, B, CFG.encoder_seq)
    prompt = torch.from_numpy(_tokens(14, B, P)).long()
    trollout.rollout(tm, tp, prompt, torch.Generator().manual_seed(0),
                     trollout.RolloutConfig(max_new_tokens=N_NEW),
                     extra_inputs={"frames": tf})
    t_enc, l_dec = CFG.encoder_seq, CFG.num_layers
    assert sorted(k1) == sorted(
        [(False, t_enc, t_enc)] * CFG.encoder_layers
        + [(True, P, P)] * l_dec + [(False, P, t_enc)] * l_dec)
    assert len(k2) == 2 * l_dec * N_NEW
    assert k2.count((t_enc - 1, t_enc)) == l_dec * N_NEW
    assert sorted(pos for pos, t in k2 if t == P + N_NEW) == sorted(
        P + i for i in range(N_NEW) for _ in range(l_dec))


# ------------------------------------------------- serving: two jobs, greedy

ORDER = ("A", "B", "A")
# the reduced config as a deployment's overrides of the full one
OVERRIDES = tuple((f.name, getattr(CFG, f.name))
                  for f in dataclasses.fields(CFG)
                  if getattr(CFG, f.name) != getattr(get_config(ARCH), f.name))


def _spec(mod, job):
    return mod.DeploymentSpec(deployment_id=f"whisper-{job}", job_id=job,
                              model_name=ARCH, role="rollout",
                              overrides=OVERRIDES)


def test_port_router_serves_whisper_like_jax_router_on_two_jobs():
    """Greedy GENERATEs with ``extra_inputs={"frames": ...}`` of two jobs
    on one group, jobs A, B, A, each round a context switch, through both
    packages' Routers (the port's WPGs given the reference WPGs'
    parameters, converted); tokens held as in the greedy rollout test."""
    prompt = np.random.default_rng(15).integers(
        3, CFG.vocab_size, (B, P)).astype(np.int32)
    jf, tf = _frames(16, B, CFG.encoder_seq)
    jrouter = JRouter()
    jdeps = {job: jrouter.deploy(_spec(japi, job), group_id=0) for job in "AB"}
    for seed, dep in enumerate(jdeps.values()):
        dep.init(seed=seed)
    jrouter.drain()
    flat = {job: {k: np.asarray(v) for k, v in j_canonical_flat(
        dep.wpg.params(), **IS_ARR).items()} for job, dep in jdeps.items()}
    jouts = []
    for job in ORDER:
        fut = jdeps[job].generate(jnp.asarray(prompt), max_new_tokens=N_NEW,
                                  temperature=0.0,
                                  extra_inputs={"frames": jf})
        with jax.disable_jit():
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
                                   extra_inputs={"frames": tf}
                                   ).wait(timeout=120)
                for job in ORDER]

    held = 0
    for job, jtok, out in zip(ORDER, jouts, outs):
        ttok = out["tokens"].numpy()
        assert ttok.shape == jtok.shape == (B, N_NEW)
        assert np.isfinite(out["logprobs"].numpy()).all()
        wpg = jdeps[job].wpg
        held += _held_tokens(
            wpg.model, wpg.params(), build_model(CFG),
            convert.params_from_reference(flat[job], CFG), prompt, jtok,
            ttok, {"frames": jf}, {"frames": tf})
    assert held >= len(ORDER) * B * N_NEW // 2, held
    assert [s["to_job"] for s in router.switch_log[-len(ORDER):]] == \
        list(ORDER)
    assert sum(s["t_offload"] > 0 for s in router.switch_log) >= 2
