"""Tensor-parallel execution over a slice of virtual CPU devices, held
against the JAX package's single-device functions.

The reference lays a node group's state out on its slice under the
``"tp"`` rules and lets GSPMD partition every op; the port runs the same
layout by hand (``models/layers.py``): column-parallel Q/K/V and MLP
inputs, K1 and K2 at each device's local heads, row-parallel outputs
summed by an all-reduce, the tied embedding split over the vocabulary,
and the head-dim-parallel decode where the KV heads do not split. At the
reference e2e test's TINY shapes (4 query heads, 2 KV heads, head_dim 8)
model=2 splits both head counts and model=4 is the mixed case: the query
heads split, the KV heads do not, the cache splits over head_dim and a
decode step takes the head-dim-parallel branch.

The reference's seeded parameters are carried by canonical key
(``models/convert.py``) and laid out on the slice. Tolerances against the
reference: f32 2e-3 and bf16 5e-2 of the reference's largest magnitude;
f32 runs patch the embedding's bf16 cast out of both packages.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jtransformer
from repro.configs import get_config as j_get_config
from repro.models import common as jcommon
from repro.models import layers as jl
from repro.models import sharding as jshd
from repro.models.common import canonical_flat as j_canonical_flat
from repro.models.registry import build_model as j_build_model
from repro.rl import grpo as jgrpo
from repro.rl.rollout import _pad_cache as j_pad_cache
from repro.train import optimizer as jopt
from repro.train import train_state as jts
from repro.train.train_state import TrainState as JTrainState
from repro_torch.configs import get_config
from repro_torch.core import api
from repro_torch.core.router import Router
from repro_torch.core.state_manager import StateManager
from repro_torch.core.worker import WorkerProcessGroup
from repro_torch.launch.mesh import DevicePlane, make_local_mesh
from repro_torch.models import common, convert
from repro_torch.models import layers as tl
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as ttransformer
from repro_torch.models.layers import make_ctx
from repro_torch.models.registry import build_model
from repro_torch.rl import rollout as trollout
from repro_torch.train import optimizer as topt

torch.set_num_threads(1)

CPU = torch.device("cpu")
TINY = (("num_layers", 2), ("d_model", 32), ("num_heads", 4),
        ("num_kv_heads", 2), ("head_dim", 8), ("d_ff", 64),
        ("vocab_size", 64), ("tie_embeddings", True))
CFG = get_config("qwen2-0.5b").replace(**dict(TINY))
TOL = {"float32": 2e-3, "bfloat16": 5e-2}
FAST_LR = dict(lr=1e-3, warmup_steps=1)
IS_ARR = dict(is_leaf=lambda x: hasattr(x, "shape"))
B, P_LEN, N_NEW = 2, 10, 4


class _FakeMesh:
    """A shape-only mesh for the reference's resolve."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


def _ctx(n):
    return make_ctx(make_local_mesh(1, n, devices=[CPU] * n))


def _reference(seed=0, dtype="bfloat16"):
    """The JAX model, its seeded params (cast to ``dtype``) and their
    canonical numpy leaves."""
    jm = j_build_model(j_get_config("qwen2-0.5b").replace(**dict(TINY)))
    jp = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)),
                      jm.init_params(jax.random.PRNGKey(seed)))
    flat = {k: np.asarray(v) for k, v in j_canonical_flat(jp, **IS_ARR)
            .items()}
    return jm, jp, flat


def _sharded(flat, ctx):
    params = convert.params_from_reference(flat, CFG)
    model = build_model(CFG)
    return shd.device_put(params, shd.tree_shardings(
        model.logical_axes(), ctx.mesh, ctx.rules, model.param_specs()))


def _n(x):
    if isinstance(x, shd.Sharded):
        x = shd.gather(x)
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(port, ref, tol, what=""):
    port, ref = _n(port), _n(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = float(np.abs(port - ref).max())
    bound = tol * max(1.0, float(np.abs(ref).max()))
    assert np.isfinite(port).all() and err <= bound, (what, err, bound)


def _f32_ref_embed(p, cfg, tokens, ctx=None):
    return p["embedding"][tokens]


def _f32_port_embed(p, cfg, tokens, ctx=None):
    """The port's ``embed_apply`` without the bf16 cast; over a slice the
    vocabulary-parallel lookup, which calls this per device."""
    if ctx is not None:
        return tl._embed_tp(p, cfg, tokens, ctx)
    return p["embedding"][tokens]


@pytest.fixture
def f32_models(monkeypatch):
    monkeypatch.setattr(jtransformer, "embed_apply", _f32_ref_embed)
    monkeypatch.setattr(ttransformer, "embed_apply", _f32_port_embed)
    monkeypatch.setattr(tl, "embed_apply", _f32_port_embed)


def _tuples(tree):
    return {k: tuple(v) for k, v in j_canonical_flat(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        .items()}


# ------------------------------------------------------------ the specs

@pytest.mark.parametrize("n", [2, 4])
def test_stored_specs_equal_the_reference(n):
    """The specs a WPG on an n-device slice stores for its params and
    AdamW state, and its prefill cache's, equal the reference's
    ``tree_partition_specs`` under ``"tp"`` on a (1, n) mesh."""
    sl = DevicePlane(devices=[CPU] * n, slice_size=n).slice_for_group(0)
    wpg = WorkerProcessGroup(api.DeploymentSpec(
        deployment_id="A-train", job_id="A", model_name="qwen2-0.5b",
        role="train", overrides=TINY), StateManager(mesh_slice=sl))
    wpg.execute(api.make_op(wpg.spec, api.Op.INIT, 0))
    jm = j_build_model(j_get_config("qwen2-0.5b").replace(**dict(TINY)))
    jmesh, rules = _FakeMesh({"data": 1, "model": n}), jshd.RULES_TP
    want = jts.partition_specs(jm, jmesh, rules)
    stored = {k.split("/", 1)[1]: tuple(e.sharding.spec)
              for k, e in wpg.sm.entries.items()}
    got_params = {k[len("params/"):]: v for k, v in stored.items()
                  if k.startswith("params/")}
    assert got_params == _tuples(want.params)
    for mom in ("mu", "nu"):
        got = {k[len(f"opt/{mom}/"):]: v for k, v in stored.items()
               if k.startswith(f"opt/{mom}/")}
        assert got == _tuples(getattr(want.opt_state, mom)), mom
    assert stored["opt/step"] == tuple(want.opt_state.step) == ()
    # the cache a prefill builds, against the cache specs' resolution
    tokens = torch.zeros((B, P_LEN), dtype=torch.long)
    _, _, cache = wpg.model.forward(wpg.params(), {"tokens": tokens},
                                    return_cache=True, ctx=wpg.ctx())
    jc = jm.cache_specs(B, P_LEN)
    jc = {k: v for k, v in jc.items() if k != "pos"}
    jcs = jshd.tree_partition_specs(jcommon.logical_axes(jc), jmesh, rules,
                                    jcommon.abstract_params(jc))
    assert {k: tuple(cache[k].sharding.spec) for k in ("k", "v")} == \
        _tuples(jcs)
    # n=2 splits the KV heads; n=4 (2 KV heads) splits head_dim
    assert tuple(cache["k"].sharding.spec) == (
        (None, "data", None, "model") if n == 2
        else (None, "data", None, None, "model"))


# ------------------------------------------------- forward and decode

def _forward_and_decode(n, dtype):
    jm, jp, flat = _reference(7, dtype)
    ctx = _ctx(n)
    tp = _sharded(flat, ctx)
    model = build_model(CFG)
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, CFG.vocab_size, (B, P_LEN)).astype(np.int32)
    forced = rng.integers(0, CFG.vocab_size, (B, N_NEW)).astype(np.int32)
    tol = TOL[dtype]
    jlog, _, jc = jm.forward(jp, {"tokens": jnp.asarray(prompt)},
                             return_cache=True)
    tlog, _, tc = model.forward(tp, {"tokens": torch.from_numpy(prompt)
                                     .long()}, return_cache=True, ctx=ctx)
    _close(tlog, jlog, tol, "prefill logits")
    assert tlog.device == CPU and tc["pos"] == P_LEN
    for k in ("k", "v"):
        assert isinstance(tc[k], shd.Sharded)
        _close(tc[k], jc[k], tol, f"cache {k}")
    jc, tc = j_pad_cache(jc, N_NEW), trollout._pad_cache(tc, N_NEW)
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape)
    for i in range(N_NEW):
        tok = forced[:, i:i + 1]
        jlog, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(tok)})
        tlog, tc = model.decode_step(tp, tc, {"tokens": torch.from_numpy(
            tok).long()}, ctx=ctx)
        _close(tlog, jlog, tol, f"decode {i}")
    _close(tc["k"], jc["k"], tol, "cache k after decode")
    assert tc["pos"] == P_LEN + N_NEW


@pytest.mark.parametrize("n", [2, 4])
def test_tp_forward_cache_and_decode_match_the_reference_bf16(n):
    _forward_and_decode(n, "bfloat16")


@pytest.mark.parametrize("n", [2, 4])
def test_tp_forward_cache_and_decode_match_the_reference_f32(n, f32_models):
    _forward_and_decode(n, "float32")


def test_tp_greedy_rollout_equals_one_device_in_f32(f32_models):
    """A greedy rollout over 2 and over 4 devices picks the one-device
    rollout's tokens (f32: the partial sums move the logits by ~1e-6)."""
    _, _, flat = _reference(3, "float32")
    model = build_model(CFG)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, CFG.vocab_size, (B, P_LEN))).long()
    cfg = trollout.RolloutConfig(max_new_tokens=6, greedy=True)
    gen = torch.Generator().manual_seed(0)
    want, wlp, _ = trollout.rollout(
        model, convert.params_from_reference(flat, CFG), prompt, gen, cfg)
    for n in (2, 4):
        ctx = _ctx(n)
        got, glp, _ = trollout.rollout(model, _sharded(flat, ctx), prompt,
                                       gen, cfg, ctx=ctx)
        assert torch.equal(got, want), n
        _close(glp, wlp, 1e-4, f"logprobs {n}")


# ------------------------------------------------ hd-parallel decode

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [(0, None), (5, 30.0)])
def test_hd_parallel_decode_attention_matches_the_reference(dtype, window,
                                                            softcap):
    """The port's ``_hd_parallel_decode_attention`` with ``ctx=None``
    against the reference's on the same numpy inputs; over 4 devices (the
    head_dim in 4 blocks, partial scores all-reduced) against the port's
    own whole computation."""
    rng = np.random.default_rng(11)
    b, s, h, kh, d, t = 2, 1, 6, 2, 16, 12
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, t, kh, d)).astype(np.float32)
    pos = np.full((b, s), 9, np.int32)
    mask = np.arange(t) <= 9
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jl._hd_parallel_decode_attention(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v)),
        q_positions=jnp.asarray(pos), kv_mask=jnp.asarray(mask),
        window=window, softcap=softcap, scale=0.25)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    opts = dict(q_positions=torch.from_numpy(pos),
                kv_mask=torch.from_numpy(mask), window=window,
                softcap=softcap, scale=0.25)
    got = tl._hd_parallel_decode_attention(tq, tk, tv, **opts)
    _close(got, want, TOL[dtype], "ctx=None")
    ctx = _ctx(4)
    blocks = [[x[..., i * 4:(i + 1) * 4] for i in range(4)]
              for x in (tq, tk, tv)]
    parts = tl._hd_parallel_decode_attention(*blocks, **opts, ctx=ctx)
    _close(torch.cat(parts, dim=-1), got,
           1e-6 if dtype == "float32" else 1e-2, "over 4 devices")


# ---------------------------------------------------------- training

def _batch(seed, b=4, s=16, p_len=8):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, CFG.vocab_size, (b, s)).astype(np.int32)
    behave = np.zeros((b, s), np.float32)
    behave[:, p_len:] = -rng.uniform(3.6, 4.6, (b, s - p_len))
    mask = np.zeros((b, s), np.float32)
    mask[:, p_len:] = 1.0
    adv = rng.standard_normal(b).astype(np.float32)
    return {"tokens": tokens, "behavior_logprobs": behave,
            "advantages": adv, "loss_mask": mask}


def _replicas_equal(leaf, what):
    """Every replica of each block of a ``Sharded`` leaf holds the same
    bits."""
    first = {}
    for pos, t in enumerate(leaf.locals):
        b = leaf.sharding.block(pos, leaf.dim())
        if b in first:
            assert torch.equal(t, first[b]), (what, pos)
        else:
            first[b] = t


def _wpg(n, flat):
    plane = DevicePlane(devices=[CPU] * n, slice_size=n)
    wpg = WorkerProcessGroup(
        api.DeploymentSpec(deployment_id="A-train", job_id="A",
                           model_name="qwen2-0.5b", role="train",
                           overrides=TINY),
        StateManager(mesh_slice=plane.slice_for_group(0)),
        adamw_cfg=topt.AdamWConfig(**FAST_LR))
    wpg.execute(api.make_op(wpg.spec, api.Op.INIT,
                            params=convert.params_from_reference(flat, CFG)))
    return wpg


def test_update_actor_over_a_slice_matches_one_device_and_the_reference(
        f32_models):
    """One UPDATE_ACTOR at model=2 in f32: the metrics, the parameters and
    the first moments against the port on one device and against the
    reference's single-device ``make_update_actor``; replicated leaves
    stay the same bits on every device."""
    jm, jp, flat = _reference(5, "float32")
    batch = _batch(6)
    one, two = _wpg(1, flat), _wpg(2, flat)
    assert isinstance(two.params()["ln_f"]["scale"], shd.Sharded)
    m1 = one.execute(api.make_op(one.spec, api.Op.UPDATE_ACTOR, batch))
    m2 = two.execute(api.make_op(two.spec, api.Op.UPDATE_ACTOR, batch))
    jstep = jgrpo.make_update_actor(jm, jgrpo.GRPOConfig(),
                                    jopt.AdamWConfig(**FAST_LR))
    jstate, jmet = jstep(JTrainState(jp, jopt.init(jp, jopt.AdamWConfig(
        **FAST_LR)), jnp.asarray(0, jnp.int32)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    assert m2["grad_norm"] > 0
    for k in ("loss", "pg_loss", "kl", "grad_norm", "lr"):
        _close(torch.tensor(m2[k]), torch.tensor(m1[k]), 1e-5, k)
        _close(torch.tensor(m2[k]), jmet[k], TOL["float32"], k)
    p1 = common.canonical_flat(one.params())
    p2 = common.canonical_flat(two.params())
    mu1 = common.canonical_flat(one.opt_state().mu)
    mu2 = common.canonical_flat(two.opt_state().mu)
    jpp = j_canonical_flat(jstate.params, **IS_ARR)
    jmu = j_canonical_flat(jstate.opt_state.mu, **IS_ARR)
    for k in p1:
        _close(p2[k], p1[k], 1e-5, f"param {k}")
        _close(p2[k], jpp[k], TOL["float32"], f"param {k}")
        _close(mu2[k], mu1[k], 1e-4, f"mu {k}")
        _close(mu2[k], jmu[k], TOL["float32"], f"mu {k}")
        for leaf in (p2[k], mu2[k]):
            _replicas_equal(leaf, k)
    assert int(shd.local_tensors(two.opt_state().step)[1]) == 1


def test_sync_weights_into_target_slice_shardings_is_bit_identical():
    """SYNC_WEIGHTS from a 2-device group into a rollout deployment on
    another 2-device group lands in the target's own layout, and into a
    one-device group as plain tensors, bit-identical either way; a later
    update leaves the synced weights as they were."""
    plane = DevicePlane(devices=[CPU] * 4, slice_size=2)
    router = Router(device_plane=plane, wpg_factory=functools.partial(
        WorkerProcessGroup, adamw_cfg=topt.AdamWConfig(**FAST_LR)))
    spec = functools.partial(api.DeploymentSpec, job_id="A",
                             model_name="qwen2-0.5b", overrides=TINY)
    train = router.deploy(spec(deployment_id="A-train", role="train"), 0)
    roll = router.deploy(spec(deployment_id="A-roll", role="rollout"), 1)
    train.init(seed=1)
    roll.init(seed=2)
    router.drain()
    fut = train.sync_weights(roll)
    router.drain()
    assert fut.result()["synced_bytes"] > 0
    src = common.canonical_flat(train.wpg.params())
    dst = common.canonical_flat(roll.wpg.params())
    ids = set(roll.wpg.mesh_slice.device_ids())
    assert ids == {2, 3}
    want = common.canonical_flat(roll.wpg.param_shardings())
    for k, v in dst.items():
        assert v.sharding == want[k], k
        assert {int(i) for i in v.sharding.mesh.device_ids.flat} == ids
        assert torch.equal(shd.gather(v), shd.gather(src[k])), k
    before = {k: shd.gather(v).clone() for k, v in dst.items()}
    router.drain()
    upd = train.update_actor(_batch(2))
    router.drain()
    assert upd.result()["grad_norm"] > 0
    for k, v in common.canonical_flat(roll.wpg.params()).items():
        assert torch.equal(shd.gather(v), before[k]), k
    # into a one-device slice: plain tensors, the same bits
    one = WorkerProcessGroup(spec(deployment_id="B-roll", role="rollout",
                                  job_id="B"),
                             StateManager(mesh_slice=DevicePlane(
                                 devices=[CPU]).slice_for_group(0)))
    train.wpg.execute(api.make_op(train.wpg.spec, api.Op.SYNC_WEIGHTS, one))
    got = common.canonical_flat(one.params())
    for k, v in common.canonical_flat(train.wpg.params()).items():
        assert torch.is_tensor(got[k]) and torch.equal(got[k],
                                                       shd.gather(v)), k
