"""The port's hybrid (zamba2) slice, held against the JAX package on the CPU.

At ``reduced_config("zamba2-7b")``: 15 blocks (2 shared-attention
applications of 6 Mamba2 blocks each and 1 trailing block), d_model 64, 4
heads of width 16 (MHA), 16 SSD heads of width 8, state 16, chunk 8. The
JAX package's seeded parameters are carried across by
``models/convert.py``; inputs are made with numpy from a seed.

The JAX side runs op by op (``jax.disable_jit``). Compiled, XLA fuses
elementwise chains and skips bf16 roundings between them, and at 15 blocks
its compiled forward differs from its own op-by-op run by as much as the
logit tolerance below, so the compiled run is no tighter reference than
the port. Where JAX's top-2 logit margin is within that tolerance the
two argmaxes may part (at the greedy test's seed, row 1 parts at step 2,
where the margin is one bf16 step of the logit), so greedy choices are
held exactly above the tolerance, step by step on JAX's tokens, and the
rollouts are compared until they part (``_held_tokens``).

Tolerances:
- bf16 logits at 2^-6 * max |logit| (four bf16 ulps of the largest
  logit), against both JAX SSD variants, as tests/test_torch_mamba2.py: the
  port's scan keeps the intra-chunk scores in f32, ``ssd_chunked`` rounds
  them to bf16, the Pallas kernel's function does not;
- bf16 cache entries (KV, conv windows) as layer outputs, rtol = atol =
  5e-2; the f32 SSM states at 1e-2.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba2 as jmamba2
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.core import api as japi
from repro.core.router import Router as JRouter
from repro.kernels import ops as jops
from repro.models.common import canonical_flat as j_canonical_flat
from repro.models.registry import build_model as j_build_model
from repro.rl import rollout as jrollout
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import api
from repro_torch.core.router import Router
from repro_torch.launch.mesh import DevicePlane
from repro_torch.models import common, convert
from repro_torch.models import hybrid as thybrid
from repro_torch.models.registry import build_model
from repro_torch.rl import data as data_lib
from repro_torch.rl import rollout as trollout

torch.set_num_threads(1)

ARCH = "zamba2-7b"
CFG = reduced_config(ARCH)
J_CFG = j_reduced_config(ARCH)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
STATE_TOL = dict(rtol=1e-2, atol=1e-2)
B, P, N_NEW = 2, 20, 6           # a prompt of 20: two chunks of 8 and 4
IS_ARR = dict(is_leaf=lambda x: hasattr(x, "shape"))


def _np(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x) else
                      jnp.asarray(x, jnp.float32))


def _check_logits(j, t):
    j = _np(j)
    np.testing.assert_allclose(_np(t), j, rtol=0,
                               atol=2.0 ** -6 * np.abs(j).max())


@functools.lru_cache(maxsize=None)
def _reference(seed):
    """The JAX model, its seeded params and their canonical numpy leaves."""
    jm = j_build_model(J_CFG)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in j_canonical_flat(jp, **IS_ARR).items()}
    return jm, jp, flat


def _port(flat):
    return build_model(CFG), convert.params_from_reference(flat, CFG)


def _pallas_scan(monkeypatch):
    monkeypatch.setattr(
        jmamba2, "ssd_chunked",
        lambda x, dt, A, B, C, chunk, initial_state=None:
        jops.ssd(x, dt, A, B, C, chunk=chunk))


def test_layout_param_count_and_cache_specs_match_jax():
    assert thybrid._layout(CFG) == (2, 6, 1)
    assert thybrid._layout(get_config(ARCH)) == (11, 6, 4)
    full = build_model(get_config(ARCH))
    assert full.param_count() == j_build_model(
        j_get_config(ARCH)).param_count() == 5_893_372_128
    specs = build_model(CFG).cache_specs(3, 40)
    jspecs = j_build_model(J_CFG).cache_specs(3, 40)
    assert set(specs) == set(jspecs) - {"pos"}      # pos stays a host int
    for k, s in specs.items():
        assert s.shape == tuple(jspecs[k].shape), k
        assert str(s.dtype).split(".")[-1] == jnp.dtype(jspecs[k].dtype).name


def test_convert_round_trip_is_bit_exact_by_canonical_key():
    """The twice-stacked ``mamba_grouped`` leaves (n_attn, per_group, ...)
    and the rest cross both ways by canonical key, bit for bit."""
    _, _, flat = _reference(0)
    m = build_model(CFG)
    params = convert.params_from_reference(flat, CFG)
    assert set(common.canonical_flat(m.param_specs())) == set(flat)
    assert params["mamba_grouped"]["mixer"]["A_log"].shape == (2, 6, 16)
    assert params["mamba_grouped"]["mixer"]["A_log"].dtype == torch.float32
    assert m.param_count() == sum(v.size for v in flat.values())
    back = convert.params_to_reference(params)
    assert set(back) == set(flat)
    for k, arr in flat.items():
        assert back[k].dtype == arr.dtype and back[k].shape == arr.shape, k
        bits = np.uint32 if arr.dtype == np.float32 else np.uint16
        np.testing.assert_array_equal(back[k].view(bits), arr.view(bits),
                                      err_msg=k)
    a = m.init_params(torch.Generator().manual_seed(3))
    b = m.init_params(torch.Generator().manual_seed(3))
    for k, t in common.canonical_flat(a).items():
        assert tuple(t.shape) == flat[k].shape, k
        assert torch.equal(t, common.canonical_flat(b)[k]), k


@pytest.mark.parametrize("jax_scan", ["ssd_chunked", "pallas_kernel"])
def test_prefill_caches_and_teacher_forced_decode_match_jax(jax_scan,
                                                            monkeypatch):
    if jax_scan == "pallas_kernel":
        _pallas_scan(monkeypatch)
    jm, jp, flat = _reference(7)
    tm, tp = _port(flat)
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, CFG.vocab_size, (B, P)).astype(np.int32)
    forced = rng.integers(0, CFG.vocab_size, (B, 4)).astype(np.int32)
    with jax.disable_jit():
        jlog, _, jc = jm.forward(jp, {"tokens": jnp.asarray(prompt)},
                                 return_cache=True)
    tlog, _, tc = tm.forward(tp, {"tokens": torch.from_numpy(prompt).long()},
                             return_cache=True)
    _check_logits(jlog, tlog)
    assert tc["pos"] == P and set(tc) == set(jc)
    for key in ("attn_k", "attn_v", "conv_g", "conv_t", "ssm_g", "ssm_t"):
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        assert str(tc[key].dtype).split(".")[-1] == jc[key].dtype.name, key
        tol = STATE_TOL if key.startswith("ssm") else BF16_TOL
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **tol,
                                   err_msg=key)
    # the decode grows the attention caches (only) by the new tokens
    jc = jrollout._pad_cache(jc, 4)
    tc = trollout._pad_cache(tc, 4)
    for key in ("attn_k", "attn_v", "conv_g", "ssm_g"):
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
    kept = {k: tc[k] for k in ("attn_k", "conv_g", "ssm_t")}
    for i in range(forced.shape[1]):
        tok = forced[:, i:i + 1]
        with jax.disable_jit():
            jlog, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(tok)})
        tlog, tc = tm.decode_step(tp, tc,
                                  {"tokens": torch.from_numpy(tok).long()})
        _check_logits(jlog, tlog)
    assert tc["pos"] == P + forced.shape[1]
    assert all(tc[k] is t for k, t in kept.items())     # written in place
    np.testing.assert_allclose(_np(tc["ssm_g"]), _np(jc["ssm_g"]),
                               **STATE_TOL)
    np.testing.assert_allclose(_np(tc["attn_v"]), _np(jc["attn_v"]),
                               **BF16_TOL)


def _held_tokens(jm, jp, tm, tp, prompts, jtok, ttok, jextra=None,
                 textra=None, op_by_op=True):
    """Hold greedy tokens against JAX's. Both models are teacher-forced on
    JAX's tokens: at every step where JAX's top-2 logit margin is above the
    logit tolerance the port's logits pick JAX's token, and at every step
    they rank JAX's token within the tolerance of their top. The port's
    own rollout follows JAX's tokens until it parts at a step where JAX's
    margin is within the tolerance, to a token within the tolerance of
    JAX's top; the row's later tokens then continue another sequence and
    are not compared. ``jextra`` / ``textra``: each side's inputs beside
    the tokens (whisper's frames). ``op_by_op``: JAX's forward under
    ``jax.disable_jit``, else as ``jm.forward`` runs. Prints each parting;
    returns the number of steps whose choice the tolerance decides."""
    seq = np.concatenate([prompts, jtok[:, :-1]], 1)
    with jax.disable_jit(op_by_op):
        jl = _np(jm.forward(jp, {"tokens": jnp.asarray(seq),
                                 **(jextra or {})})[0])
    tl = _np(tm.forward(tp, {"tokens": torch.from_numpy(seq).long(),
                             **(textra or {})})[0])
    jl, tl = (x[:, prompts.shape[1] - 1:] for x in (jl, tl))
    tol = 2.0 ** -6 * np.abs(jl).max()
    top2 = np.sort(jl, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > tol
    np.testing.assert_array_equal(tl.argmax(-1)[clear], jtok[clear])
    picked = np.take_along_axis(tl, jtok[..., None].astype(np.int64), -1)
    assert (picked[..., 0] >= tl.max(-1) - tol).all()
    for b in range(ttok.shape[0]):
        parted = np.flatnonzero(ttok[b] != jtok[b])
        if parted.size:
            i = parted[0]
            print(f"row {b} step {i}: port {ttok[b, i]}, JAX {jtok[b, i]}; "
                  f"JAX's top-2 margin {top2[b, i, 1] - top2[b, i, 0]}, "
                  f"tolerance {tol}")
            assert not clear[b, i], (b, i)
            assert jl[b, i, ttok[b, i]] >= top2[b, i, 1] - tol, (b, i)
    return int(clear.sum())


def test_greedy_rollout_matches_jax_rollout():
    jm, jp, flat = _reference(7)
    tm, tp = _port(flat)
    prompt = np.random.default_rng(9).integers(
        3, CFG.vocab_size, (B, P)).astype(np.int32)
    with jax.disable_jit():
        jtok, jlp, jalive = jrollout.rollout(
            jm, jp, jnp.asarray(prompt), jax.random.PRNGKey(0),
            jrollout.RolloutConfig(max_new_tokens=N_NEW, greedy=True))
    # greedy at a positive temperature: the sampler's generator is unused
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    ttok, tlp, talive = trollout.rollout(
        tm, tp, torch.from_numpy(prompt).long(), gen,
        trollout.RolloutConfig(max_new_tokens=N_NEW, temperature=0.7,
                               greedy=True))
    assert torch.equal(gen.get_state(), state)
    jtok, ttok = np.asarray(jtok), ttok.numpy()
    assert ttok.shape == jtok.shape == (B, N_NEW)
    held = _held_tokens(jm, jp, tm, tp, prompt, jtok, ttok)
    assert held >= B * N_NEW // 2, held
    same = ttok == jtok
    np.testing.assert_allclose(tlp.numpy()[same], np.asarray(jlp)[same],
                               rtol=0, atol=5e-2)
    assert np.isfinite(tlp.numpy()).all()
    np.testing.assert_array_equal(talive.numpy()[same],
                                  np.asarray(jalive)[same])


# ------------------------------------------------- serving: two jobs, greedy

ORDER = ("A", "B", "A")


# the reduced config as a deployment's overrides of the full one
OVERRIDES = tuple((f.name, getattr(CFG, f.name))
                  for f in dataclasses.fields(CFG)
                  if getattr(CFG, f.name) != getattr(get_config(ARCH), f.name))


def _spec(mod, job):
    return mod.DeploymentSpec(deployment_id=f"hyb-{job}", job_id=job,
                              model_name=ARCH, role="rollout",
                              overrides=OVERRIDES)


def test_port_router_serves_zamba2_like_jax_router_on_two_jobs():
    """Greedy rollouts of two jobs on one group, jobs A, B, A, each round a
    context switch; tokens compared as in the greedy rollout test."""
    prompts = np.asarray(next(data_lib.MathDataset(seed=0).batches(B, P))[0],
                         np.int32) % CFG.vocab_size
    jrouter = JRouter()
    jdeps = {job: jrouter.deploy(_spec(japi, job), group_id=0) for job in "AB"}
    for seed, dep in enumerate(jdeps.values()):
        dep.init(seed=seed)
    jrouter.drain()
    flat = {job: {k: np.asarray(v) for k, v in j_canonical_flat(
        dep.wpg.params(), **IS_ARR).items()} for job, dep in jdeps.items()}
    jouts = []
    for job in ORDER:
        fut = jdeps[job].generate(jnp.asarray(prompts), max_new_tokens=N_NEW,
                                  temperature=0.0)
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
        outs = [deps[job].generate(prompts, max_new_tokens=N_NEW,
                                   temperature=0.0).wait(timeout=120)
                for job in ORDER]

    held = 0
    for job, jtok, out in zip(ORDER, jouts, outs):
        ttok = out["tokens"].numpy()
        assert ttok.shape == jtok.shape == (B, N_NEW)
        assert np.isfinite(out["logprobs"].numpy()).all()
        wpg = jdeps[job].wpg
        held += _held_tokens(
            wpg.model, wpg.params(), build_model(CFG),
            convert.params_from_reference(flat[job], CFG), prompts, jtok, ttok)
    assert held >= len(ORDER) * B * N_NEW // 2, held
    assert [s["to_job"] for s in router.switch_log[-len(ORDER):]] == \
        list(ORDER)
    assert sum(s["t_offload"] > 0 for s in router.switch_log) >= 2
    for job, dep in deps.items():
        mixer = dep.wpg.params()["mamba_grouped"]["mixer"]
        for key in ("A_log", "D", "dt_bias"):
            np.testing.assert_array_equal(
                mixer[key].numpy().view(np.uint32),
                flat[job][f"mamba_grouped/mixer/{key}"].view(np.uint32))
