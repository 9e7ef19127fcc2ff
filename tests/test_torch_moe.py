"""The port's MoE family, held against the JAX package on the CPU.

Three configs: paper-qwen3-30b-a3b (128 experts top-8, qk-norm), granite-
moe-3b-a800m (40 experts top-8, tied embeddings) and arctic-480b (128
experts top-2 beside a dense residual MLP), each at ``reduced_config``: 4
layers, d_model 64, 8 experts top-4 (arctic top-2) of width 48, vocab 128.
The JAX package's seeded parameters are carried across by
``models/convert.py``; inputs are made with numpy from a seed. The JAX
models run op by op (``jax.disable_jit``): compiled, XLA skips bf16
roundings between fused ops, and a router input one rounding away can
pick another expert.

Capacity: a prefill of S tokens gives each expert ``expert_capacity(cfg,
S)`` slots per batch row and drops the choices ranked past it; a decode
step (S = 1, capacity 8 >= k) drops none. So an MoE model's teacher-forced
forward and its incremental decode differ, in the reference too: the
port's decode is held against the reference's decode.

Tolerances: f32 2e-3 and bf16 5e-2 (rtol = atol) for the FFN output and
the f32 aux loss (the aux loss of a bf16 input at 2e-3: it is f32 arithmetic
on the same routing); whole-model bf16 logits at 2^-6 * max |logit| (four
bf16 ulps of the largest, as tests/test_torch_model.py); bf16 cache entries
at 5e-2. Gradients are held against the JAX model run in f32 (the same
parameter values upcast): op by op in bf16 JAX sums broadcast cotangents
in bf16 (ROADMAP.md Queue 3, "bf16 cotangent sums"), and compiled it
skips roundings; each leaf within 5e-2 of its largest f32 gradient.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.core import api as japi
from repro.core.router import Router as JRouter
from repro.core.state_manager import StateManager as JStateManager
from repro.core.worker import WorkerProcessGroup as JWPG
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.models.common import canonical_flat as j_canonical_flat
from repro.models.registry import build_model as j_build_model
from repro.rl import grpo as jgrpo
from repro.rl import rollout as jrollout
from repro.train import optimizer as jopt
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import api
from repro_torch.core.router import Router
from repro_torch.core.state_manager import StateManager
from repro_torch.core.worker import WorkerProcessGroup
from repro_torch.launch.mesh import DevicePlane
from repro_torch.models import common, convert
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.registry import build_model
from repro_torch.rl import data as data_lib
from repro_torch.rl import grpo as tgrpo
from repro_torch.rl import rollout as trollout
from repro_torch.train import optimizer as topt

torch.set_num_threads(1)

ARCHS = ("paper-qwen3-30b-a3b", "granite-moe-3b-a800m", "arctic-480b")
TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
B, P, N_NEW = 2, 20, 6
IS_ARR = dict(is_leaf=lambda x: hasattr(x, "shape"))


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check_logits(j, t):
    j = _np(j)
    np.testing.assert_allclose(_np(t), j, rtol=0,
                               atol=2.0 ** -6 * np.abs(j).max())


@functools.lru_cache(maxsize=None)
def _reference(arch, seed):
    """The reduced JAX model, its seeded params and their numpy leaves."""
    jm = j_build_model(j_reduced_config(arch))
    jp = jm.init_params(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in j_canonical_flat(jp, **IS_ARR).items()}
    return jm, jp, flat


# ------------------------------------------------------------ sizes and keys

@pytest.mark.parametrize("arch", ARCHS)
def test_expert_capacity_matches_jax(arch):
    for cfg, jcfg in ((get_config(arch), j_get_config(arch)),
                      (reduced_config(arch), j_reduced_config(arch))):
        got = [tmoe.expert_capacity(cfg, s) for s in range(1, 513)]
        assert got == [jmoe.expert_capacity(jcfg, s) for s in range(1, 513)]
        assert min(got) == 8 and all(c % 8 == 0 for c in got)
    # the serving path's prefill and the training forward
    assert tmoe.expert_capacity(get_config(ARCHS[0]), 256) == 24
    assert tmoe.expert_capacity(get_config(ARCHS[1]), 128) == 32


@pytest.mark.parametrize("arch,total,active", [
    ("paper-qwen3-30b-a3b", 30_532_122_624, 3_353_032_704),
    ("granite-moe-3b-a800m", 3_298_793_472, 882_874_368),
    ("arctic-480b", None, None),
])
def test_param_counts_match_jax_at_full_width(arch, total, active):
    """From the specs, without allocating a parameter."""
    m, jm = build_model(get_config(arch)), j_build_model(j_get_config(arch))
    assert m.param_count() == jm.param_count()
    assert m.active_param_count() == jm.active_param_count()
    if total is not None:
        assert (m.param_count(), m.active_param_count()) == (total, active)
    specs = common.canonical_flat(m.param_specs())
    jspecs = j_canonical_flat(jm.param_specs())
    assert specs.keys() == jspecs.keys()
    for k, s in specs.items():
        assert s.shape == jspecs[k].shape, k
        assert str(s.dtype).split(".")[-1] == jnp.dtype(jspecs[k].dtype).name
    assert specs["layers/moe/router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip_is_bit_exact_by_canonical_key(arch):
    """The f32 router and the (L, E, d, f) expert stacks cross both ways by
    canonical key, bit for bit; the seeded init repeats."""
    _, _, flat = _reference(arch, 0)
    cfg = reduced_config(arch)
    params = convert.params_from_reference(flat, cfg)
    moe = params["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert tuple(moe["wi_gate"].shape) == (4, 8, 64, 48)
    assert tuple(moe["wo"].shape) == (4, 8, 48, 64)
    assert ("mlp" in params["layers"]) == cfg.dense_residual
    back = convert.params_to_reference(params)
    assert set(back) == set(flat)
    for k, arr in flat.items():
        assert back[k].dtype == arr.dtype and back[k].shape == arr.shape, k
        bits = np.uint32 if arr.dtype == np.float32 else np.uint16
        np.testing.assert_array_equal(back[k].view(bits), arr.view(bits),
                                      err_msg=k)
    m = build_model(cfg)
    a = m.init_params(torch.Generator().manual_seed(3))
    b = m.init_params(torch.Generator().manual_seed(3))
    for k, t in common.canonical_flat(a).items():
        assert tuple(t.shape) == flat[k].shape, k
        assert torch.equal(t, common.canonical_flat(b)[k]), k


# ------------------------------------------------------------- sliced init

def test_init_draws_a_leaf_above_the_threshold_in_slices(monkeypatch):
    """A leaf of more than INIT_SLICE_ELEMS elements is drawn slice by slice
    along its leading axis straight into the bf16 leaf: no f32 draw holds
    more than the threshold. A leaf within it is drawn whole."""
    monkeypatch.setattr(common, "INIT_SLICE_ELEMS", 1000)
    draws = []
    randn = torch.randn

    def spy(*args, **kw):
        out = randn(*args, **kw)
        draws.append((out.numel(), out.dtype))
        return out

    monkeypatch.setattr(torch, "randn", spy)
    big = common.spec((8, 30, 20), (None, None, None))        # 4,800
    small = common.spec((40, 25), (None, None), scale=2.0)    # 1,000
    tree = common.init_params(torch.Generator().manual_seed(0),
                              {"big": big, "small": small})
    assert draws == [(600, torch.float32)] * 8 + [(1000, torch.float32)]
    assert tree["big"].dtype == torch.bfloat16
    std = tree["big"].float().std().item()
    assert abs(std - 1 / math.sqrt(8 * 30)) < 0.1 / math.sqrt(8 * 30)
    # a slice holds several rows where one row is small
    draws.clear()
    common.init_params(torch.Generator().manual_seed(0),
                       {"w": common.spec((10, 300), (None, None))})
    assert draws == [(900, torch.float32)] * 3 + [(300, torch.float32)]


def test_init_gives_the_same_tree_for_the_same_seed(monkeypatch):
    monkeypatch.setattr(common, "INIT_SLICE_ELEMS", 4096)
    m = build_model(reduced_config(ARCHS[0]))
    sliced = [k for k, s in common.canonical_flat(m.param_specs()).items()
              if math.prod(s.shape) > 4096 and s.init not in ("zeros",
                                                               "ones")]
    assert "layers/moe/wi_gate" in sliced
    a, b, c = (common.canonical_flat(m.init_params(
        torch.Generator().manual_seed(s))) for s in (5, 5, 6))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["layers/moe/wi_gate"], c["layers/moe/wi_gate"])


# --------------------------------------------------------------- the layer

def _layer_params(arch, dtype, seed, bias_expert=None):
    """Random FFN params of a reduced layer ({"moe"[, "mlp"]}) as (jax,
    torch) trees; the router stays f32. At 0.1 of unit scale the outputs
    of unit-scale inputs are O(1), the scale the bf16 tolerance is set for.
    ``bias_expert`` makes every token pick that expert first (with inputs
    whose first feature is 5), and no other expert gains from it."""
    cfg = reduced_config(arch)
    specs = {k: v for k, v in ttransformer.layer_param_specs(cfg).items()
             if k in ("moe", "mlp")}
    rng = np.random.default_rng(seed)
    jflat, tflat = {}, {}
    for k, s in common.canonical_flat(specs).items():
        arr = (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
        if k == "moe/router" and bias_expert is not None:
            arr[0] = 0.0
            arr[0, bias_expert] = 10.0
        dt = "float32" if s.dtype == torch.float32 else dtype
        jflat[k] = jnp.asarray(arr).astype(getattr(jnp, dt))
        tflat[k] = torch.from_numpy(arr).to(getattr(torch, dt))
    return (common.canonical_unflatten(specs, jflat),
            common.canonical_unflatten(specs, tflat))


def _inputs(dtype, shape, seed, first=None):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if first is not None:
        x[..., 0] = first
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, dtype):
    """The MoE FFN (``_ffn``: moe_apply, plus arctic's dense residual MLP)
    and its aux loss, at B=3 S=40."""
    cfg, jcfg = reduced_config(arch), j_reduced_config(arch)
    jp, tp = _layer_params(arch, dtype, 1)
    jx, tx = _inputs(dtype, (3, 40, cfg.d_model), 2)
    with jax.disable_jit():
        jo, jaux = jtransformer._ffn(jp, jcfg, jx, None)
    to, taux = ttransformer._ffn(tp, cfg, tx)
    assert to.dtype == tx.dtype and taux.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), **TOL[dtype])
    np.testing.assert_allclose(float(taux), float(jaux), **TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_the_same_choices_as_jax(arch):
    """Expert 3 is every token's first choice: past its capacity each row
    drops its later tokens' choices of it, in token order (the stable sort).
    Both packages drop the same ones: a token's output changes with the
    capacity exactly where a choice was dropped."""
    cfg, jcfg = reduced_config(arch), j_reduced_config(arch)
    s = 40
    cap = tmoe.expert_capacity(cfg, s)
    assert cap < s
    jp, tp = _layer_params(arch, "float32", 3, bias_expert=3)
    jx, tx = _inputs("float32", (3, s, cfg.d_model), 4, first=5.0)
    roomy = dict(capacity_factor=100.0)

    def changed(out, out_roomy):
        return (np.abs(_np(out) - _np(out_roomy)).max(-1) > 1e-3)

    jdrop = changed(jmoe.moe_apply(jp["moe"], jcfg, jx)[0],
                    jmoe.moe_apply(jp["moe"], jcfg.replace(**roomy), jx)[0])
    out, _ = tmoe.moe_apply(tp["moe"], cfg, tx)
    tdrop = changed(out, tmoe.moe_apply(tp["moe"], cfg.replace(**roomy),
                                        tx)[0])
    _, ids, _ = tmoe.route(tp["moe"]["router"], cfg, tx)
    dropped = tmoe.slot_ranks(ids, cfg.num_experts) >= cap
    assert (ids[dropped] == 3).all()
    want = np.zeros((3, s), bool)
    want[:, cap:] = True
    np.testing.assert_array_equal(dropped.any(-1).numpy(), want)
    np.testing.assert_array_equal(tdrop, want)
    np.testing.assert_array_equal(jdrop, want)
    np.testing.assert_allclose(_np(out), _np(jmoe.moe_apply(
        jp["moe"], jcfg, jx)[0]), **TOL["float32"])


# --------------------------------------------------------------- the model

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_match_jax(arch):
    jm, jp, flat = _reference(arch, 7)
    cfg = reduced_config(arch)
    tm, tp = build_model(cfg), convert.params_from_reference(flat, cfg)
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (B, 4)).astype(np.int32)
    with jax.disable_jit():
        jlog, jaux, jc = jm.forward(jp, {"tokens": jnp.asarray(prompt)},
                                    return_cache=True)
    tlog, taux, tc = tm.forward(tp, {"tokens": torch.from_numpy(prompt).long()},
                                return_cache=True)
    _check_logits(jlog, tlog)
    assert float(jaux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), **TOL["float32"])
    assert tc["pos"] == P
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]),
                                   **TOL["bfloat16"], err_msg=key)
    jc, tc = jrollout._pad_cache(jc, 4), trollout._pad_cache(tc, 4)
    for i in range(forced.shape[1]):
        tok = forced[:, i:i + 1]
        with jax.disable_jit():
            jlog, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(tok)})
        tlog, tc = tm.decode_step(tp, tc,
                                  {"tokens": torch.from_numpy(tok).long()})
        _check_logits(jlog, tlog)
    assert tc["pos"] == P + forced.shape[1]


def _decode_logits(forward, decode_step, pad_cache, prompts, tokens):
    """Logits of each step of a rollout that emitted ``tokens``: the
    prefill's last, then each decode step teacher-forced on ``tokens``."""
    logits, _, cache = forward(prompts)
    steps, cache = [_np(logits[:, -1])], pad_cache(cache, tokens.shape[1])
    for i in range(tokens.shape[1] - 1):
        logits, cache = decode_step(cache, tokens[:, i:i + 1])
        steps.append(_np(logits[:, -1]))
    return np.stack(steps, 1)


def _held_tokens(jm, jp, tm, tp, prompts, jtok, ttok):
    """Hold greedy tokens against JAX's, through both packages' DECODE
    paths (a teacher-forced forward drops choices past the prefill's
    capacity where the decode drops none), teacher-forced on JAX's tokens:
    at every live step where JAX's top-2 logit margin is above the logit
    tolerance the port picks JAX's token, and at every live step it ranks
    JAX's token within the tolerance of its top. A row is live up to and
    including its first EOS; the rollout forces EOS after it. The port's
    own rollout follows JAX's tokens until it parts, at a step whose
    margin is within the tolerance. Returns the number of steps held."""
    with jax.disable_jit():
        jl = _decode_logits(
            lambda t: jm.forward(jp, {"tokens": jnp.asarray(t)},
                                 return_cache=True),
            lambda c, t: jm.decode_step(jp, c, {"tokens": jnp.asarray(t)}),
            jrollout._pad_cache, prompts, jtok)
    with torch.inference_mode():
        tl = _decode_logits(
            lambda t: tm.forward(tp, {"tokens": torch.tensor(t).long()},
                                 return_cache=True),
            lambda c, t: tm.decode_step(tp, c,
                                        {"tokens": torch.tensor(t).long()}),
            trollout._pad_cache, prompts, jtok)
    eos = jrollout.RolloutConfig().eos_id
    live = np.cumsum(np.cumsum(jtok == eos, 1), 1) <= 1
    tol = 2.0 ** -6 * np.abs(jl).max()
    top2 = np.sort(jl, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0] > tol) & live
    np.testing.assert_array_equal(tl.argmax(-1)[clear], jtok[clear])
    picked = np.take_along_axis(tl, jtok[..., None].astype(np.int64), -1)
    assert (picked[..., 0] >= tl.max(-1) - tol)[live].all()
    for b in range(ttok.shape[0]):
        parted = np.flatnonzero((ttok[b] != jtok[b]) & live[b])
        if parted.size:
            assert not clear[b, parted[0]], (b, parted[0])
    return int(clear.sum())


# the reduced config as a deployment's overrides of the full one
def _overrides(arch):
    cfg, full = reduced_config(arch), get_config(arch)
    return tuple((f.name, getattr(cfg, f.name))
                 for f in dataclasses.fields(cfg)
                 if getattr(cfg, f.name) != getattr(full, f.name))


def test_port_router_serves_qwen3_moe_like_jax_router_on_two_jobs():
    """Greedy rollouts of two jobs on one group, jobs A, B, A, each round a
    context switch; tokens held as in tests/test_torch_hybrid.py. The f32
    router leaves come back bit-exact from the host tier."""
    arch, order = ARCHS[0], ("A", "B", "A")
    cfg = reduced_config(arch)

    def spec(mod, job):
        return mod.DeploymentSpec(deployment_id=f"moe-{job}", job_id=job,
                                  model_name=arch, role="rollout",
                                  overrides=_overrides(arch))

    prompts = np.asarray(next(data_lib.MathDataset(seed=0).batches(B, P))[0],
                         np.int32) % cfg.vocab_size
    jrouter = JRouter()
    jdeps = {job: jrouter.deploy(spec(japi, job), group_id=0) for job in "AB"}
    for seed, dep in enumerate(jdeps.values()):
        dep.init(seed=seed)
    jrouter.drain()
    flat = {job: {k: np.asarray(v) for k, v in j_canonical_flat(
        dep.wpg.params(), **IS_ARR).items()} for job, dep in jdeps.items()}
    jouts = []
    for job in order:
        fut = jdeps[job].generate(jnp.asarray(prompts), max_new_tokens=N_NEW,
                                  temperature=0.0)
        with jax.disable_jit():
            jrouter.drain()
        jouts.append(np.asarray(fut.wait()["tokens"]))

    router = Router(device_plane=DevicePlane(devices=[torch.device("cpu")]))
    deps = {job: router.deploy(spec(api, job), group_id=0) for job in "AB"}
    with router:
        for job, dep in deps.items():
            assert dep.wpg.cfg == cfg
            params = convert.params_from_reference(flat[job], cfg)
            dep.call(api.Op.INIT, params=params).wait(timeout=60)
        outs = [deps[job].generate(prompts, max_new_tokens=N_NEW,
                                   temperature=0.0).wait(timeout=120)
                for job in order]

    held = 0
    for job, jtok, out in zip(order, jouts, outs):
        ttok = out["tokens"].numpy()
        assert ttok.shape == jtok.shape == (B, N_NEW)
        assert np.isfinite(out["logprobs"].numpy()).all()
        wpg = jdeps[job].wpg
        held += _held_tokens(
            wpg.model, wpg.params(), build_model(cfg),
            convert.params_from_reference(flat[job], cfg), prompts, jtok,
            ttok)
    assert held >= len(order) * B * N_NEW // 2, held
    assert [s["to_job"] for s in router.switch_log[-len(order):]] == \
        list(order)
    assert sum(s["t_offload"] > 0 for s in router.switch_log) >= 2
    for job, dep in deps.items():
        np.testing.assert_array_equal(
            dep.wpg.params()["layers"]["moe"]["router"].numpy().view(
                np.uint32),
            flat[job]["layers/moe/router"].view(np.uint32))


# ---------------------------------------------------------------- training

def _train_inputs(monkeypatch, dtype, seed=3):
    """Reduced granite with its tied embedding scaled by 1/16 (a spread
    policy, as tests/test_torch_train.py) and a seeded GRPO batch: the JAX
    side in f32, the port's parameters in ``dtype`` (in f32 the embedding
    casts to bf16 are patched out on both sides)."""
    monkeypatch.setattr(jtransformer, "embed_apply",
                        lambda p, cfg, tokens, ctx=None:
                        p["embedding"][tokens])
    if dtype == "float32":
        monkeypatch.setattr(ttransformer, "embed_apply",
                            lambda p, cfg, tokens: p["embedding"][tokens])
    arch = ARCHS[1]
    jm, jp, _ = _reference(arch, seed)
    jp = dict(jp, embed={"embedding": jp["embed"]["embedding"] / 16})
    flat = {k: np.asarray(v) for k, v in j_canonical_flat(jp, **IS_ARR).items()}
    params = convert.params_from_reference(flat, reduced_config(arch))
    if dtype == "float32":
        params = common.tree_map(lambda t: t.float(), params,
                                 is_leaf=torch.is_tensor)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    rng = np.random.default_rng(seed)
    b, s, p_len = 8, 24, 10
    behave = np.zeros((b, s), np.float32)
    behave[:, p_len:] = -rng.uniform(4.4, 5.4, size=(b, s - p_len))
    mask = np.zeros((b, s), np.float32)
    mask[:, p_len:] = 1.0
    batch = {"tokens": rng.integers(3, 128, size=(b, s)).astype(np.int32),
             "behavior_logprobs": behave,
             "advantages": rng.standard_normal(b).astype(np.float32),
             "loss_mask": mask}
    return jm, jp32, batch, build_model(reduced_config(arch)), params


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _close_rel(port, ref, what, rel):
    port, ref = _np(port), _np(ref)
    bound = rel * (max(1.0, abs(float(ref))) if ref.ndim == 0
                   else float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert np.isfinite(port).all() and err <= bound, (what, err, bound)


def test_grpo_loss_with_the_aux_term_matches_jax(monkeypatch):
    """The port in bf16, as it trains, against the f32 reference."""
    jm, jp, batch, tm, params = _train_inputs(monkeypatch, "bfloat16")
    cfg = dict(aux_coef=0.5)          # the aux term a visible share
    jloss, jmet = jgrpo.grpo_loss(jp, jm, _jbatch(batch),
                                  jgrpo.GRPOConfig(**cfg))
    tloss, tmet = tgrpo.grpo_loss(params, tm, _tbatch(batch),
                                  tgrpo.GRPOConfig(**cfg))
    assert tmet.keys() == jmet.keys()
    assert float(tmet["aux"]) > 0.1 * abs(float(tmet["pg_loss"]))
    np.testing.assert_allclose(float(tloss), float(tmet["pg_loss"])
                               + 0.5 * float(tmet["aux"]), rtol=1e-6)
    _close_rel(tloss, jloss, "loss", 5e-2)
    for k in jmet:
        _close_rel(tmet[k], jmet[k], k, 5e-2)


def test_compute_grads_match_jax_grad_on_router_and_experts(monkeypatch):
    """In f32 on both sides, where both route every token alike: at these
    widths bf16 and f32 runs route 0.3-0.7 % of the choices differently
    (near-ties among 8 experts), which moves the router's gradient by 6 %
    of its largest, so a bf16 run is no check of the MoE's gradient."""
    jm, jp, batch, tm, params = _train_inputs(monkeypatch, "float32")
    jgrads, jmet = jgrpo.compute_grads(jp, jm, _jbatch(batch),
                                       jgrpo.GRPOConfig(), None)
    tgrads, tmet = tgrpo.compute_grads(params, tm, _tbatch(batch),
                                       tgrpo.GRPOConfig())
    jflat = j_canonical_flat(jgrads, **IS_ARR)
    tflat = common.canonical_flat(tgrads)
    assert jflat.keys() == tflat.keys()
    assert {"layers/moe/router", "layers/moe/wi_gate", "layers/moe/wi_up",
            "layers/moe/wo"} <= tflat.keys()
    for k, g in tflat.items():
        assert float(np.abs(_np(jflat[k])).max()) > 0, k
        _close_rel(g, jflat[k], k, 2e-3)
    for k in jmet:
        _close_rel(tmet[k], jmet[k], k, 2e-3)


def test_wpg_update_actor_matches_jax_wpg(monkeypatch):
    """UPDATE_ACTOR through each package's WPG (train role) from the same
    f32 parameters: the metrics (aux included), the f32 moments and the new
    parameters, router and experts written in place."""
    jm, jp, batch, tm, params = _train_inputs(monkeypatch, "float32")
    arch, fast = ARCHS[1], dict(lr=1e-3, warmup_steps=1)

    def spec(mod):
        return mod.DeploymentSpec(deployment_id="A-train", job_id="A",
                                  model_name=arch, role="train",
                                  overrides=_overrides(arch))

    jw = JWPG(spec(japi), JStateManager(),
              adamw_cfg=jopt.AdamWConfig(**fast))
    jw.execute(japi.make_op(jw.spec, japi.Op.INIT, 0))
    jw._store(params=jp)
    jgrads, _ = jgrpo.compute_grads(jp, jm, _jbatch(batch), jw.grpo_cfg,
                                    None)
    jmet = jw.execute(japi.make_op(jw.spec, japi.Op.UPDATE_ACTOR,
                                   _jbatch(batch)))
    tw = WorkerProcessGroup(spec(api), StateManager(),
                            adamw_cfg=topt.AdamWConfig(**fast))
    tw.execute(api.make_op(tw.spec, api.Op.INIT, params=params))
    ptrs = {k: v.data_ptr() for k, v in
            common.canonical_flat(tw.params()).items()}
    tmet = tw.execute(api.make_op(tw.spec, api.Op.UPDATE_ACTOR, batch))
    for k in ("loss", "pg_loss", "kl", "aux", "grad_norm", "lr"):
        _close_rel(tmet[k], jmet[k], k, 2e-3)
    assert tmet["aux"] > 0 and tmet["grad_norm"] > 0
    tp = common.canonical_flat(tw.params())
    tmu = common.canonical_flat(tw.opt_state().mu)
    jg = j_canonical_flat(jgrads, **IS_ARR)
    jnew = j_canonical_flat(jw.params(), **IS_ARR)
    jmu = j_canonical_flat(jw.opt_state().mu, **IS_ARR)
    for k, v in tp.items():
        assert v.data_ptr() == ptrs[k], k
        _close_rel(tmu[k], jmu[k], f"mu {k}", 2e-3)
        # AdamW's first step is about lr * sign(g): compared where the
        # gradient's sign is clear of f32 rounding
        g = _np(jg[k])
        sel = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(_np(v)[sel], _np(jnew[k])[sel],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for k in ("layers/moe/router", "layers/moe/wi_gate", "layers/moe/wo"):
        assert not torch.equal(tp[k], common.canonical_flat(params)[k]), k
