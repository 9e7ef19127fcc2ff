"""The port's mamba2 slice, held against the JAX package on the CPU.

At ``reduced_config("mamba2-2.7b")`` (3 layers, d_model 64, 16 SSD heads of
width 8, state 16, chunk 8). Inputs are made with numpy from a seed and
handed to both packages; whole-model parameters are the JAX package's
seeded init carried across by ``models/convert.py``.

Tolerances:
- the SSD chunk scan as tests/test_kernels.py holds the TPU kernel: y at
  2e-3 in f32 and 2e-2 in bf16 (both sides keep y in f32 and round once),
  the f32 final state at 1e-2;
- mixer outputs as tests/test_torch_model.py's layers: f32 2e-3, bf16 5e-2;
- whole-model bf16 logits at 2^-6 * max |logit| (four bf16 ulps of the
  largest logit), as the dense test. The port's scan keeps the intra-chunk
  scores in f32 (K3's function); the JAX model's ``ssd_chunked`` rounds
  them to bf16. Both JAX variants are compared: as it stands, and with its
  scan replaced by the Pallas kernel's function (interpret mode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba2 as jmamba2
from repro.configs import reduced_config as j_reduced_config
from repro.core import api as japi
from repro.core.router import Router as JRouter
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.common import canonical_flat as j_canonical_flat
from repro.models.registry import build_model as j_build_model
from repro_torch.configs import reduced_config
from repro_torch.core import api
from repro_torch.core.router import Router
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch.mesh import DevicePlane
from repro_torch.models import common, convert
from repro_torch.models import mamba2 as tmamba2
from repro_torch.models.registry import build_model
from repro_torch.rl import data as data_lib
from repro_torch.rl.rollout import _pad_cache

torch.set_num_threads(1)

ARCH = "mamba2-2.7b"
CFG = reduced_config(ARCH)
SSD_TOL = {"float32": (dict(rtol=2e-3, atol=2e-3), dict(rtol=1e-2, atol=1e-2)),
           "bfloat16": (dict(rtol=2e-2, atol=2e-2), dict(rtol=1e-2, atol=1e-2))}
LAYER_TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
             "bfloat16": dict(rtol=5e-2, atol=5e-2)}
SSD_SHAPES = [(1, 64, 2, 16, 32, 16), (2, 96, 4, 8, 16, 32),
              (1, 72, 2, 8, 16, 24)]          # those of tests/test_kernels.py


def _both(arr, dtype):
    j = jnp.asarray(arr, jnp.float32).astype(getattr(jnp, dtype))
    t = torch.from_numpy(np.asarray(arr, np.float32)).to(getattr(torch, dtype))
    return j, t


def _np(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x) else x,
                      np.float32)


def _ssd_inputs(b, s, h, p, n, dtype, seed=4):
    """x in ``dtype``; dt, A, B, C in f32, as tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    x = _both(rng.standard_normal((b, s, h, p)), dtype)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))      # softplus
    A = -np.exp(rng.standard_normal(h))
    rest = [_both(a, "float32") for a in (dt, A)]
    rest += [_both(rng.standard_normal((b, s, 1, n)), "float32")
             for _ in range(2)]
    return [x] + rest


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ref_ssd_matches_jax_pallas_kernel(b, s, h, p, n, chunk, dtype):
    pairs = _ssd_inputs(b, s, h, p, n, dtype)
    jy, jst = jops.ssd(*[j for j, _ in pairs], chunk=chunk)
    ty, tst = tops.ssd(*[t for _, t in pairs], chunk=chunk)
    assert ty.dtype == getattr(torch, dtype) and tst.dtype == torch.float32
    ytol, stol = SSD_TOL[dtype]
    np.testing.assert_allclose(_np(ty), _np(jy), **ytol)
    np.testing.assert_allclose(_np(tst), _np(jst), **stol)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ref_ssd_matches_naive_recurrence_in_both_packages(b, s, h, p, n,
                                                           chunk):
    pairs = _ssd_inputs(b, s, h, p, n, "float32", seed=5)
    ty, tst = tref.ref_ssd(*[t for _, t in pairs], chunk=chunk)
    ny, nst = tref.ref_ssd_naive(*[t for _, t in pairs])
    jy, jst = jref.ref_ssd_naive(*[j for j, _ in pairs])
    ytol, stol = SSD_TOL["float32"]
    for y, st in ((ny, nst), (jy, jst)):
        np.testing.assert_allclose(_np(ty), _np(y), **ytol)
        np.testing.assert_allclose(_np(tst), _np(st), **stol)


def test_cpu_ssd_wrapper_takes_min_chunk_and_counts_nothing():
    tops.reset_launches()
    pairs = _ssd_inputs(1, 5, 2, 8, 16, "float32")
    y, st = tops.ssd(*[t for _, t in pairs], chunk=256)     # chunk -> 5
    ye, ste = tref.ref_ssd_naive(*[t for _, t in pairs])
    torch.testing.assert_close(y, ye, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(st, ste, rtol=2e-3, atol=2e-3)
    assert tops.LAUNCHES["ssd"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixer_prefill_and_decode_match_jax(dtype):
    """mixer_apply with return_state (prefill of 20 = two chunks + 4), then
    three decode steps against the returned state, whose conv and ssm the
    port updates in place."""
    rng = np.random.default_rng(6)
    specs = common.canonical_flat(tmamba2.mixer_param_specs(CFG))
    flat = {}
    for k, s in specs.items():
        arr = rng.standard_normal(s.shape) * 0.2
        if k == "A_log":
            arr = np.log(rng.uniform(1, 16, s.shape))
        flat[k] = _both(arr, "float32" if s.dtype == torch.float32 else dtype)
    tmpl = tmamba2.mixer_param_specs(CFG)
    jp = common.canonical_unflatten(tmpl, {k: v[0] for k, v in flat.items()})
    tp = common.canonical_unflatten(tmpl, {k: v[1] for k, v in flat.items()})
    jcfg = j_reduced_config(ARCH)
    jx, tx = _both(rng.standard_normal((2, 20, 64)), dtype)
    jo, jc = jmamba2.mixer_apply(jp, jcfg, jx, return_state=True)
    to, tc = tmamba2.mixer_apply(tp, CFG, tx, return_state=True)
    np.testing.assert_allclose(_np(to), _np(jo), **LAYER_TOL[dtype])
    np.testing.assert_allclose(_np(tc["ssm"]), _np(jc["ssm"]), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_array_equal(_np(tc["conv"]), _np(jc["conv"]))
    for _ in range(3):
        jx, tx = _both(rng.standard_normal((2, 1, 64)), dtype)
        jo, jc = jmamba2.mixer_apply(jp, jcfg, jx, cache=jc)
        conv, ssm = tc["conv"], tc["ssm"]
        to, tc = tmamba2.mixer_apply(tp, CFG, tx, cache=tc)
        assert tc["conv"] is conv and tc["ssm"] is ssm      # in place
        np.testing.assert_allclose(_np(to), _np(jo), **LAYER_TOL[dtype])
        np.testing.assert_allclose(_np(tc["ssm"]), _np(jc["ssm"]), rtol=1e-2,
                                   atol=1e-2)


def _reference_params(seed):
    jm = j_build_model(j_reduced_config(ARCH))
    jp = jm.init_params(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in
            j_canonical_flat(jp, is_leaf=lambda x: hasattr(x, "shape")).items()}
    return jm, jp, flat


@pytest.mark.parametrize("jax_scan", ["ssd_chunked", "pallas_kernel"])
def test_prefill_and_teacher_forced_decode_logits_match_jax(jax_scan,
                                                            monkeypatch):
    if jax_scan == "pallas_kernel":
        monkeypatch.setattr(
            jmamba2, "ssd_chunked",
            lambda x, dt, A, B, C, chunk, initial_state=None:
            jops.ssd(x, dt, A, B, C, chunk=chunk))
    jm, jp, flat = _reference_params(seed=7)
    tm = build_model(CFG)
    tp = convert.params_from_reference(flat, CFG)
    rng = np.random.default_rng(8)
    b, p, n = 2, 20, 8
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
    assert tc["pos"] == p
    for key in ("conv", "ssm"):
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
    tc = _pad_cache(tc, n)                  # an ssm cache has no T axis
    assert tc["conv"].shape == jc["conv"].shape
    for i in range(n):
        tok = forced[:, i:i + 1]
        jlog, jc = jdec(jp, jc, jnp.asarray(tok))
        tlog, tc = tm.decode_step(tp, tc, {"tokens": torch.from_numpy(tok).long()})
        check(jlog, tlog)
    assert tc["pos"] == p + n


def test_convert_round_trip_is_bit_exact_with_f32_leaves():
    _, _, flat = _reference_params(seed=0)
    params = convert.params_from_reference(flat, CFG)
    mixer = params["layers"]["mixer"]
    for key in ("A_log", "D", "dt_bias"):
        assert mixer[key].dtype == torch.float32, key
    assert mixer["norm"].dtype == torch.bfloat16
    back = convert.params_to_reference(params)
    assert set(back) == set(flat)
    for k, arr in flat.items():
        assert back[k].dtype == arr.dtype and back[k].shape == arr.shape, k
        bits = np.uint32 if arr.dtype == np.float32 else np.uint16
        np.testing.assert_array_equal(back[k].view(bits), arr.view(bits),
                                      err_msg=k)


def test_seeded_init_is_deterministic_keyed_like_jax_and_in_range():
    _, _, flat = _reference_params(seed=0)
    m = build_model(CFG)
    a = m.init_params(torch.Generator().manual_seed(3))
    b = m.init_params(torch.Generator().manual_seed(3))
    fa, fb = common.canonical_flat(a), common.canonical_flat(b)
    assert set(fa) == set(flat)
    for k in fa:
        assert tuple(fa[k].shape) == flat[k].shape, k
        assert str(fa[k].dtype).split(".")[-1] == flat[k].dtype.name, k
        assert torch.equal(fa[k], fb[k]), k
    assert m.param_count() == sum(v.size for v in flat.values())
    mixer = a["layers"]["mixer"]
    assert bool((mixer["A_log"] >= 0).all()) \
        and bool((mixer["A_log"] < np.log(16.0)).all())
    dt = torch.nn.functional.softplus(mixer["dt_bias"])
    assert bool((dt >= 1e-3 * (1 - 1e-5)).all()) \
        and bool((dt <= 1e-1 * (1 + 1e-5)).all())
    assert torch.equal(mixer["D"], torch.ones_like(mixer["D"]))


# ------------------------------------------------- serving: two jobs, greedy

OVERRIDES = (("num_layers", 3), ("d_model", 64), ("vocab_size", 128),
             ("ssm_state", 16), ("ssm_head_dim", 8), ("ssm_chunk", 8))
ORDER = ("A", "B", "A")
N_NEW = 6


def _spec(mod, job):
    return mod.DeploymentSpec(deployment_id=f"ssm-{job}", job_id=job,
                              model_name=ARCH, role="rollout",
                              overrides=OVERRIDES)


def test_port_router_serves_mamba2_like_jax_router_on_two_jobs():
    """Greedy rollouts of two jobs on one group (a prompt of 10 is one
    chunk of 8 and a ragged 2), token by token while the two sides agree;
    a disagreement is accepted only at a near-tie of the JAX model's top-2
    logits (within the logit tolerance), and ends that row's comparison."""
    prompts = np.asarray(next(data_lib.MathDataset(seed=0).batches(3, 10))[0],
                         np.int32) % 128
    jrouter = JRouter()
    jdeps = {job: jrouter.deploy(_spec(japi, job), group_id=0) for job in "AB"}
    for seed, dep in enumerate(jdeps.values()):
        dep.init(seed=seed)
    jrouter.drain()
    flat = {job: {k: np.asarray(v) for k, v in j_canonical_flat(
        dep.wpg.params(), is_leaf=lambda x: hasattr(x, "shape")).items()}
        for job, dep in jdeps.items()}
    jouts = []
    for job in ORDER:
        fut = jdeps[job].generate(jnp.asarray(prompts), max_new_tokens=N_NEW,
                                  temperature=0.0)
        jrouter.drain()
        jouts.append(np.asarray(fut.wait()["tokens"]))

    router = Router(device_plane=DevicePlane(devices=[torch.device("cpu")]))
    deps = {job: router.deploy(_spec(api, job), group_id=0) for job in "AB"}
    with router:
        for job, dep in deps.items():
            params = convert.params_from_reference(flat[job], dep.wpg.cfg)
            dep.call(api.Op.INIT, params=params).wait(timeout=60)
        outs = [deps[job].generate(prompts, max_new_tokens=N_NEW,
                                   temperature=0.0).wait(timeout=120)
                for job in ORDER]

    held = 0
    for job, jtok, out in zip(ORDER, jouts, outs):
        ttok = out["tokens"].numpy()
        assert ttok.shape == jtok.shape == (prompts.shape[0], N_NEW)
        assert np.isfinite(out["logprobs"].numpy()).all()
        wpg = jdeps[job].wpg
        seq = jnp.asarray(np.concatenate([prompts, jtok[:, :-1]], 1))
        logits = np.asarray(wpg.model.forward(wpg.params(), {"tokens": seq})[0],
                            np.float32)[:, prompts.shape[1] - 1:]
        top2 = np.sort(logits, axis=-1)[..., -2:]
        margin = top2[..., 1] - top2[..., 0]
        tol = 2.0 ** -6 * np.abs(logits).max()
        for b in range(ttok.shape[0]):
            for i in range(N_NEW):
                if ttok[b, i] != jtok[b, i]:
                    assert margin[b, i] <= tol, (job, b, i, margin[b, i], tol)
                    break
                held += margin[b, i] > tol
    assert held >= len(ORDER) * prompts.shape[0] * N_NEW // 2, held
    # every round switched jobs; the f32 leaves survived the host tier
    assert [s["to_job"] for s in router.switch_log[-len(ORDER):]] == \
        list(ORDER)
    assert sum(s["t_offload"] > 0 for s in router.switch_log) >= 2
    for job, dep in deps.items():
        mixer = dep.wpg.params()["layers"]["mixer"]
        for key in ("A_log", "D", "dt_bias"):
            np.testing.assert_array_equal(
                mixer[key].numpy().view(np.uint32),
                flat[job][f"layers/mixer/{key}"].view(np.uint32))
