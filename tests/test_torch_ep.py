"""The MoE family over a slice of virtual CPU devices (expert parallelism),
held against the JAX package's single-device functions.

The reference lays a group's state out on its slice under the ``"tp"``
rules and lets GSPMD partition every op; the port runs the same layout by
hand (``models/moe.py``): where the experts divide the slice, the router's
columns and the expert weights split over experts, each device's block of
f32 router logits is gathered to every device before the softmax and
top-k, each device fills its own experts' rows of the dispatch buffer and
runs their GEMMs, and the expert outputs are gathered back and combined
as on one device. Where they do not divide (6 experts over 4 devices),
the weights stay replicated and every device computes the whole MoE.

At ``reduced_config`` (4 layers, d_model 64, 8 experts top-4 of width 48,
GQA 4:2, vocab 128) model = 2 splits the KV heads and the experts (4 a
device), model = 4 splits the experts (2 a device) and takes the
head-dim-parallel decode. The reference's seeded parameters are carried
by canonical key (``models/convert.py``) and laid out on the slice.
Tolerances against the reference: bf16 5e-2 and f32 2e-3 of its largest
magnitude. The reference runs as ``jm.forward`` runs (its layer scan
compiled); the f32 runs patch the embedding's bf16 cast out of both
packages.
"""
import contextlib
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jtransformer
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models import sharding as jshd
from repro.models.common import canonical_flat as j_canonical_flat
from repro.models.registry import build_model as j_build_model
from repro.rl.rollout import _pad_cache as j_pad_cache
from repro.train import train_state as jts
from repro_torch.configs import get_config, list_configs, reduced_config
from repro_torch.core import api
from repro_torch.core.router import Router
from repro_torch.core.state_manager import StateManager
from repro_torch.core.worker import WorkerProcessGroup
from repro_torch.launch.mesh import DevicePlane, make_local_mesh
from repro_torch.models import common, convert
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as ttransformer
from repro_torch.models.layers import make_ctx
from repro_torch.models.registry import build_model
from repro_torch.rl import rollout as trollout
from repro_torch.train import optimizer as topt
from repro_torch.train import train_state as tts

torch.set_num_threads(1)

CPU = torch.device("cpu")
ARCHS = ("paper-qwen3-30b-a3b", "granite-moe-3b-a800m")
MOE_CONFIGS = tuple(a for a in list_configs()
                    if get_config(a).family == "moe")
SIX = (("num_experts", 6),)       # does not divide a 4-device slice
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


def overrides(arch, extra=()):
    """``reduced_config(arch)`` (with ``extra``) as a deployment's
    overrides of the full config."""
    cfg = reduced_config(arch).replace(**dict(extra))
    full = get_config(arch)
    return tuple((f.name, getattr(cfg, f.name))
                 for f in dataclasses.fields(cfg)
                 if getattr(cfg, f.name) != getattr(full, f.name))


def _n(x):
    if isinstance(x, shd.Sharded):
        x = shd.gather(x)
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(port, ref, tol, what=""):
    """``port`` within ``tol`` of ``ref``'s largest magnitude (at least
    1)."""
    port, ref = _n(port), _n(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = float(np.abs(port - ref).max())
    bound = tol * max(1.0, float(np.abs(ref).max()))
    assert np.isfinite(port).all() and err <= bound, (what, err, bound)


def tuples(tree):
    return {k: tuple(v) for k, v in j_canonical_flat(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        .items()}


def local_shape(shape, spec, n):
    """A leaf's per-device shape under a reference spec on a (1, n)
    mesh."""
    sizes = {"data": 1, "model": n}
    ents = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, ents):
        axes = () if e is None else (e,) if isinstance(e, str) else e
        div = int(np.prod([sizes[a] for a in axes])) if axes else 1
        out.append(dim // div)
    return tuple(out)


def stored_specs_check(arch, n):
    """The specs and per-device shapes a WPG on an n-device slice stores
    for its params and AdamW state (reduced config, allocated), and the
    full-width config's (from the specs alone), equal the reference's
    ``tree_partition_specs`` under ``"tp"`` on a (1, n) mesh."""
    jmesh, rules = _FakeMesh({"data": 1, "model": n}), jshd.RULES_TP
    full = tts.partition_specs(build_model(get_config(arch)),
                               shd.MeshShape({"data": 1, "model": n}),
                               shd.RULES_TP)
    jfull = jts.partition_specs(j_build_model(j_get_config(arch)), jmesh,
                                rules)
    assert {k: tuple(v) for k, v in common.canonical_flat(
        full.params).items()} == tuples(jfull.params)
    sl = DevicePlane(devices=[CPU] * n, slice_size=n).slice_for_group(0)
    wpg = WorkerProcessGroup(api.DeploymentSpec(
        deployment_id="A-train", job_id="A", model_name=arch, role="train",
        overrides=overrides(arch)), StateManager(mesh_slice=sl))
    wpg.execute(api.make_op(wpg.spec, api.Op.INIT, 0))
    jm = j_build_model(j_reduced_config(arch))
    want = jts.partition_specs(jm, jmesh, rules)
    jshapes = {k: tuple(v.shape) for k, v in
               j_canonical_flat(jm.param_specs()).items()}
    stored = {k.split("/", 1)[1]: e.ref for k, e in wpg.sm.entries.items()}
    params = {k[len("params/"):]: v for k, v in stored.items()
              if k.startswith("params/")}
    wp = tuples(want.params)
    assert {k: tuple(v.sharding.spec) for k, v in params.items()} == wp
    for k, v in params.items():
        for loc in v.locals:
            assert tuple(loc.shape) == local_shape(jshapes[k], wp[k], n), k
    for mom in ("mu", "nu"):
        got = {k[len(f"opt/{mom}/"):]: tuple(v.sharding.spec)
               for k, v in stored.items() if k.startswith(f"opt/{mom}/")}
        assert got == tuples(getattr(want.opt_state, mom)), mom
    return wpg, params


# ------------------------------------------------------------ the specs

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", MOE_CONFIGS)
def test_stored_specs_equal_the_reference(arch, n):
    _, params = stored_specs_check(arch, n)
    # 8 experts split over the slice: 4 or 2 a device
    for k in ("layers/moe/router", "layers/moe/wi_gate", "layers/moe/wo"):
        assert shd.splits(params[k], 2 if k.endswith("router") else 1), k
    assert params["layers/moe/wi_gate"].locals[0].shape[1] == 8 // n


# ------------------------------------------------- forward and decode

@contextlib.contextmanager
def _f32_reference():
    """The reference's embedding without its bf16 cast."""
    with mock.patch.object(jtransformer, "embed_apply",
                           lambda p, cfg, tokens, ctx=None:
                           p["embedding"][tokens]):
        yield


@functools.lru_cache(maxsize=None)
def _reference_run(arch, extra, dtype, seed=7):
    """The reduced JAX model on one device: its seeded params (cast to
    ``dtype``) as numpy leaves, a prompt and forced tokens, and its
    prefill logits, cache and teacher-forced decode logits."""
    jm = j_build_model(j_reduced_config(arch).replace(**dict(extra)))
    jp = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype))
                      if a.dtype == jnp.bfloat16 else a,
                      jm.init_params(jax.random.PRNGKey(seed)))
    flat = {k: np.asarray(v) for k, v in
            j_canonical_flat(jp, **IS_ARR).items()}
    rng = np.random.default_rng(seed + 1)
    cfg = jm.cfg
    prompt = rng.integers(0, cfg.vocab_size, (B, P_LEN)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (B, N_NEW)).astype(np.int32)
    with contextlib.nullcontext() if dtype == "bfloat16" \
            else _f32_reference():
        log, _, cache = jm.forward(jp, {"tokens": jnp.asarray(prompt)},
                                   return_cache=True)
        logits = [np.asarray(log, np.float32)]
        kv = {k: np.asarray(cache[k], np.float32) for k in ("k", "v")}
        cache = j_pad_cache(cache, N_NEW)
        for i in range(N_NEW):
            log, cache = jm.decode_step(
                jp, cache, {"tokens": jnp.asarray(forced[:, i:i + 1])})
            logits.append(np.asarray(log, np.float32))
    return flat, prompt, forced, logits, kv


def _f32_port_embed(p, cfg, tokens, ctx=None):
    if ctx is not None:
        return tl._embed_tp(p, cfg, tokens, ctx)
    return p["embedding"][tokens]


@pytest.fixture
def f32_port(monkeypatch):
    """The port's embedding without its bf16 cast, on one device and per
    device over a slice."""
    for mod in (tl, ttransformer):
        monkeypatch.setattr(mod, "embed_apply", _f32_port_embed)


def laid_out(model, params, ctx):
    return shd.device_put(params, shd.tree_shardings(
        model.logical_axes(), ctx.mesh, ctx.rules, model.param_specs()))


def _port_params(flat, cfg, dtype):
    params = convert.params_from_reference(flat, cfg)
    if dtype == "float32":
        params = common.tree_map(lambda t: t.float(), params,
                                 is_leaf=torch.is_tensor)
    return params


CASES = [(a, (), n, d) for a in ARCHS for n in (2, 4)
         for d in ("bfloat16", "float32")] + \
    [(ARCHS[1], SIX, 4, d) for d in ("bfloat16", "float32")] + \
    [("arctic-480b", (), 2, "float32")]     # the dense residual MLP


@pytest.mark.parametrize(
    "arch,extra,n,dtype", CASES,
    ids=[f"{a.split('-')[0]}{'-6experts' if e else ''}-{n}-{d}"
         for a, e, n, d in CASES])
def test_ep_forward_cache_and_decode_match_the_reference(arch, extra, n,
                                                         dtype, request):
    if dtype == "float32":
        request.getfixturevalue("f32_port")
    flat, prompt, forced, jlogits, jkv = _reference_run(arch, extra, dtype)
    cfg = reduced_config(arch).replace(**dict(extra))
    model, ctx = build_model(cfg), _ctx(n)
    params = laid_out(model, _port_params(flat, cfg, dtype), ctx)
    ep = cfg.num_experts % n == 0
    assert shd.splits(params["layers"]["moe"]["wi_gate"], 1) == ep
    tol = TOL[dtype]
    log, aux, cache = model.forward(params, {"tokens": torch.from_numpy(
        prompt).long()}, return_cache=True, ctx=ctx)
    close(log, jlogits[0], tol, "prefill logits")
    assert log.device == CPU and cache["pos"] == P_LEN
    assert aux.dim() == 0 and float(aux) > 0
    for k in ("k", "v"):
        assert isinstance(cache[k], shd.Sharded)
        close(cache[k], jkv[k], tol, f"cache {k}")
    cache = trollout._pad_cache(cache, N_NEW)
    for i in range(N_NEW):
        log, cache = model.decode_step(params, cache, {
            "tokens": torch.from_numpy(forced[:, i:i + 1]).long()}, ctx=ctx)
        close(log, jlogits[i + 1], tol, f"decode {i}")
    assert cache["pos"] == P_LEN + N_NEW


@pytest.mark.parametrize("n", [2, 4])
def test_ep_moe_ffn_equals_one_device_and_routes_alike(n, f32_port):
    """The MoE alone in f32 over the slice against one device: the same
    routing, the outputs within 1e-6 of the largest and the aux loss the
    first device's, counted once."""
    cfg = reduced_config(ARCHS[0])
    flat = _reference_run(ARCHS[0], (), "float32")[0]
    moe = {k.split("/")[-1]: torch.from_numpy(np.array(v[0])).float()
           for k, v in flat.items() if "/moe/" in k}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, 12, cfg.d_model)).astype(np.float32))
    ids = []
    route = tmoe.route

    def recording(router, cfg_, x_, logits=None):
        out = route(router, cfg_, x_, logits)
        ids.append(out[1])
        return out

    with mock.patch.object(tmoe, "route", recording):
        want, waux = tmoe.moe_apply(moe, cfg, x)
        ctx = _ctx(n)
        sh = shd.tree_shardings(
            common.logical_axes(tmoe.moe_param_specs(cfg)), ctx.mesh,
            ctx.rules, tmoe.moe_param_specs(cfg))
        got, gaux = tmoe.moe_apply(shd.device_put(moe, sh), cfg, [x] * n,
                                   ctx)
    # every device routes, and alike: the one device's choices
    assert len(ids) == n + 1
    assert all(torch.equal(i, ids[0]) for i in ids[1:])
    assert len(got) == n
    for g in got:
        assert torch.equal(g, got[0])
    close(got[0], want, 1e-6, "moe out")
    assert abs(float(gaux) - float(waux)) <= 1e-6


# ---------------------------------------------------------- training

def train_batch(seed, vocab, b=4, s=16, p_len=8):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, vocab, (b, s)).astype(np.int32)
    behave = np.zeros((b, s), np.float32)
    behave[:, p_len:] = -rng.uniform(3.6, 4.6, (b, s - p_len))
    mask = np.zeros((b, s), np.float32)
    mask[:, p_len:] = 1.0
    adv = rng.standard_normal(b).astype(np.float32)
    return {"tokens": tokens, "behavior_logprobs": behave,
            "advantages": adv, "loss_mask": mask}


def train_wpg(arch, n, params):
    plane = DevicePlane(devices=[CPU] * n, slice_size=n)
    wpg = WorkerProcessGroup(
        api.DeploymentSpec(deployment_id="A-train", job_id="A",
                           model_name=arch, role="train",
                           overrides=overrides(arch)),
        StateManager(mesh_slice=plane.slice_for_group(0)),
        adamw_cfg=topt.AdamWConfig(**FAST_LR))
    wpg.execute(api.make_op(wpg.spec, api.Op.INIT, params=params))
    return wpg


def replicas_equal(leaf, what):
    """Every replica of each block of a ``Sharded`` leaf holds the same
    bits."""
    first = {}
    for pos, t in enumerate(leaf.locals):
        b = leaf.sharding.block(pos, leaf.dim())
        if b in first:
            assert torch.equal(t, first[b]), (what, pos)
        else:
            first[b] = t


def update_actor_check(arch, n, params, batch, keys):
    """One f32 UPDATE_ACTOR on an n-device slice against one device: the
    metrics and every first moment within 1e-5 of the largest, every
    parameter within 1e-5 where its gradient's sign is clear of f32
    rounding (AdamW's first step is about lr * sign(g): a gradient near
    its eps moves by up to 2 lr on a rounding); replicated blocks the same
    bits on every device; ``keys`` moved."""
    one, sl = train_wpg(arch, 1, params), train_wpg(arch, n, params)
    m1 = one.execute(api.make_op(one.spec, api.Op.UPDATE_ACTOR, batch))
    mn = sl.execute(api.make_op(sl.spec, api.Op.UPDATE_ACTOR, batch))
    assert m1["grad_norm"] > 0 and m1.keys() == mn.keys()
    for k in m1:
        close(torch.tensor(mn[k]), torch.tensor(m1[k]), 1e-5, k)
    p1 = common.canonical_flat(one.params())
    pn = common.canonical_flat(sl.params())
    mu1 = common.canonical_flat(one.opt_state().mu)
    mun = common.canonical_flat(sl.opt_state().mu)
    start = common.canonical_flat(params)
    for k in p1:
        assert isinstance(pn[k], shd.Sharded), k
        close(mun[k], mu1[k], 1e-5, f"mu {k}")
        clear = mu1[k].abs() > 1e-3 * mu1[k].abs().max()
        close(shd.gather(pn[k])[clear], p1[k][clear], 1e-5, f"param {k}")
        replicas_equal(pn[k], k)
        replicas_equal(mun[k], k)
    for k in keys:
        assert not torch.equal(shd.gather(pn[k]), start[k]), k
    return m1, mn


@pytest.mark.parametrize("n", [2, 4])
def test_update_actor_over_a_slice_matches_one_device(n, f32_port):
    """Reduced granite in f32 (tied embedding scaled by 1/16: a spread
    policy), the MoE loss included once."""
    arch = ARCHS[1]
    flat = _reference_run(arch, (), "float32")[0]
    flat = dict(flat, **{"embed/embedding": flat["embed/embedding"] / 16})
    params = _port_params(flat, reduced_config(arch), "float32")
    m1, mn = update_actor_check(
        arch, n, params, train_batch(6, 128),
        ("layers/moe/router", "layers/moe/wi_gate", "layers/moe/wo"))
    assert m1["aux"] > 0.5 and abs(mn["aux"] - m1["aux"]) <= 1e-5


# --------------------------------------------- migration and weight sync

def migrate_and_sync_check(arch, extra=None):
    """A train deployment INITed on group 0's 2-device slice, migrated
    live to group 1's (a resharding migration: every leaf bit-exact, laid
    out on the new slice), then SYNC_WEIGHTS into a rollout deployment on
    group 0's slice, bit-exact in the target's own layout; a later update
    (its batch joined by ``extra``, the family's other inputs) leaves the
    synced weights as they were."""
    plane = DevicePlane(devices=[CPU] * 4, slice_size=2)
    router = Router(device_plane=plane, wpg_factory=functools.partial(
        WorkerProcessGroup, adamw_cfg=topt.AdamWConfig(**FAST_LR)))
    spec = functools.partial(api.DeploymentSpec, job_id="A",
                             model_name=arch, overrides=overrides(arch))
    train = router.deploy(spec(deployment_id="A-train", role="train"), 0)
    train.init(seed=1)
    router.drain()
    wpg = train.wpg
    before = {k: shd.gather(v).clone() for k, v in
              common.canonical_flat(wpg.params()).items()}
    moved = router.reassign_job("A", 1)
    assert moved > 0 and router.migrate_log[-1]["cross_mesh"] is True
    assert set(wpg.mesh_slice.device_ids()) == {2, 3}
    for k, v in common.canonical_flat(wpg.params()).items():
        assert {int(i) for i in v.sharding.mesh.device_ids.flat} == {2, 3}
        assert torch.equal(shd.gather(v), before[k]), k
    roll = router.deploy(spec(deployment_id="A-roll", role="rollout"), 0)
    roll.init(seed=2)
    router.drain()
    fut = train.sync_weights(roll)
    router.drain()
    assert fut.result()["synced_bytes"] > 0
    want = common.canonical_flat(roll.wpg.param_shardings())
    dst = common.canonical_flat(roll.wpg.params())
    for k, v in common.canonical_flat(wpg.params()).items():
        assert dst[k].sharding == want[k], k
        assert torch.equal(shd.gather(dst[k]), shd.gather(v)), k
    synced = {k: shd.gather(v).clone() for k, v in dst.items()}
    upd = train.update_actor(dict(
        train_batch(2, reduced_config(arch).vocab_size), **(extra or {})))
    router.drain()
    assert np.isfinite(upd.result()["loss"])
    for k, v in common.canonical_flat(roll.wpg.params()).items():
        assert torch.equal(shd.gather(v), synced[k]), k


def test_moe_job_migrates_across_slices_and_syncs_bit_exact():
    migrate_and_sync_check(ARCHS[0])
