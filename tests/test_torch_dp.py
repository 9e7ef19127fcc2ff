"""Data and pod axes: a mesh of data rows, each running the
tensor-parallel program on its block of the batch, held against the JAX
package's single-device functions and against the port on one device.

- ``update_actor`` on a (2, 2) ``data`` x ``model`` mesh under ``tp``
  (ZeRO-2: the moments and the gradient split over ``data``, the
  parameter all-gathered after the update) and ``fsdp_tp`` (the embed dim
  over ``data`` too, all-gathered where it is used), in f32: the metrics,
  the first moments and the parameters (where the gradient's sign is clear
  of rounding) against one device (1e-5) and against the reference's
  ``make_update_actor`` (``TOL``); every device's blocks are
  those the specs give (``train_state.partition_specs``, which
  ``tests/test_torch_sharding.py`` holds equal to the reference's).
- The forward, prefill cache and decode on (2, 2) and (2, 1, 2)
  ``pod`` x ``data`` x ``model``, bf16 and f32, against the reference.
- zamba2's context-parallel decode under ``long`` (the KV cache's
  sequence over ``data`` = 2, K2's log-sum-exp combine), including steps
  where one block holds no live key, against the reference's one-device
  ``decode_step`` (run op by op) and the port on one device.
- The plain K2's log-sum-exp against one taken directly.
- The cost model: one data row's counts (``layers.Ctx.rows``) times the
  rows equal the counts of every device of a (2, 2) ``meta`` mesh,
  exactly, for a train, a prefill and a decode step; the collectives of a
  dense forward equal their closed forms.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jtransformer
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models.common import canonical_flat as j_canonical_flat
from repro.models.registry import build_model as j_build_model
from repro.rl import grpo as jgrpo
from repro.rl.rollout import _pad_cache as j_pad_cache
from repro.train import optimizer as jopt
from repro.train.train_state import TrainState as JTrainState
from repro_torch.configs import SHAPES, get_config, reduced_config
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.launch import hlo_cost
from repro_torch.launch.mesh import Mesh
from repro_torch.models import common, convert
from repro_torch.models import layers as tl
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as ttransformer
from repro_torch.models.layers import make_ctx, row_logits
from repro_torch.models.registry import build_model
from repro_torch.rl import grpo
from repro_torch.rl import rollout as trollout
from repro_torch.train import optimizer as topt
from repro_torch.train import train_state as ts

torch.set_num_threads(1)

CPU = torch.device("cpu")
META = torch.device("meta")
TINY = (("num_layers", 2), ("d_model", 32), ("num_heads", 4),
        ("num_kv_heads", 2), ("head_dim", 8), ("d_ff", 64),
        ("vocab_size", 64), ("tie_embeddings", True))
CFG = get_config("qwen2-0.5b").replace(**dict(TINY))
TOL = {"float32": 2e-3, "bfloat16": 5e-2}
FAST_LR = dict(lr=1e-3, warmup_steps=1)
IS_ARR = dict(is_leaf=lambda x: hasattr(x, "shape"))
B, P_LEN, N_NEW = 4, 10, 4


def _mesh(shape, device=CPU):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    return Mesh(np.full(shape, device, dtype=object), axes)


def _reference(seed=0, dtype="bfloat16"):
    jm = j_build_model(j_get_config("qwen2-0.5b").replace(**dict(TINY)))
    jp = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)),
                      jm.init_params(jax.random.PRNGKey(seed)))
    flat = {k: np.asarray(v) for k, v in j_canonical_flat(jp, **IS_ARR)
            .items()}
    return jm, jp, flat


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


def _f32_port_embed(p, cfg, tokens, ctx=None):
    if ctx is not None:
        return tl._embed_tp(p, cfg, tokens, ctx)
    return p["embedding"][tokens]


@pytest.fixture
def f32_models(monkeypatch):
    """Both packages' embedding without its bf16 cast."""
    monkeypatch.setattr(jtransformer, "embed_apply",
                        lambda p, cfg, tokens, ctx=None:
                        p["embedding"][tokens])
    monkeypatch.setattr(ttransformer, "embed_apply", _f32_port_embed)
    monkeypatch.setattr(tl, "embed_apply", _f32_port_embed)


def _batch(seed, b=8, s=16, p_len=8):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, CFG.vocab_size, (b, s)).astype(np.int32)
    behave = np.zeros((b, s), np.float32)
    behave[:, p_len:] = -rng.uniform(3.6, 4.6, (b, s - p_len))
    mask = np.zeros((b, s), np.float32)
    mask[:, p_len:] = 1.0
    adv = rng.standard_normal(b).astype(np.float32)
    return {"tokens": tokens, "behavior_logprobs": behave,
            "advantages": adv, "loss_mask": mask}


def _state_on(params, mesh, rules, adamw, n=None):
    """A train state of ``params`` laid out on ``mesh`` by the specs of
    ``train_state.shardings`` (ZeRO-2 moments)."""
    model = build_model(CFG)
    shs = ts.shardings(model, mesh, shd.named_rules(rules), zero=True)
    st = ts.TrainState(params, topt.init(params, adamw),
                       torch.zeros((), dtype=torch.int32))
    return ts.TrainState(
        shd.device_put(st.params, shs.params, n),
        topt.AdamWState(*(shd.device_put(getattr(st.opt_state, f),
                                         getattr(shs.opt_state, f), n)
                          for f in ("step", "mu", "nu"))),
        shd.device_put(st.step, shs.step, n))


def _blocks_as_specs(leaf, spec, what):
    """Every device's local tensor is its block of the leaf by ``spec``
    (and its replicas the same bits)."""
    assert tuple(leaf.sharding.spec) == tuple(spec), (what, leaf.sharding)
    glob = shd.gather(leaf)
    for pos, t in enumerate(leaf.locals):
        assert torch.equal(t, glob[leaf.sharding.slices(pos, leaf.shape)]), \
            (what, pos)


# ---------------------------------------------------------- training

@pytest.mark.parametrize("rules", ["tp", "fsdp_tp"])
def test_update_actor_over_data_rows_matches_one_device_and_the_reference(
        rules, f32_models):
    jm, jp, flat = _reference(5, "float32")
    batch = _batch(6)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    adamw = topt.AdamWConfig(**FAST_LR)
    model = build_model(CFG)
    step = grpo.make_update_actor(model, adamw=adamw)
    one = ts.TrainState(*_state_on(convert.params_from_reference(flat, CFG),
                                   _mesh((1, 1)), rules, adamw))
    _, m1 = step(one, tbatch)
    mesh = _mesh((2, 2))
    ctx = make_ctx(mesh, rules)
    dp = _state_on(convert.params_from_reference(flat, CFG), mesh, rules,
                   adamw)
    _, m2 = step(dp, tbatch, ctx=ctx)
    jstep = jgrpo.make_update_actor(jm, jgrpo.GRPOConfig(),
                                    jopt.AdamWConfig(**FAST_LR))
    jstate, jmet = jstep(JTrainState(jp, jopt.init(jp, jopt.AdamWConfig(
        **FAST_LR)), jnp.asarray(0, jnp.int32)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    assert float(m2["grad_norm"]) > 0
    for k in ("loss", "pg_loss", "kl", "grad_norm", "lr"):
        _close(m2[k], m1[k], 1e-5, k)
        _close(m2[k], jmet[k], TOL["float32"], k)
    specs = ts.partition_specs(model, mesh, shd.named_rules(rules))
    flats = [common.canonical_flat(t) for t in (
        one.params, one.opt_state.mu, dp.params, dp.opt_state.mu,
        dp.opt_state.nu, specs.params, specs.opt_state.mu)]
    p1, mu1, p2, mu2, nu2, pspec, mspec = flats
    jpp = j_canonical_flat(jstate.params, **IS_ARR)
    jmu = j_canonical_flat(jstate.opt_state.mu, **IS_ARR)
    split = 0
    for k in p1:
        # AdamW's first step is about lr * sign(g): held where the sign is
        # clear of f32 rounding (``tests/test_torch_ep.py``)
        clear = (mu1[k].abs() > 1e-3 * mu1[k].abs().max()).numpy()
        got = _n(p2[k])
        _close(got[clear], _n(p1[k])[clear], 1e-5, f"param {k}")
        _close(got[clear], _n(jpp[k])[clear], TOL["float32"], f"param {k}")
        _close(mu2[k], mu1[k], 1e-5, f"mu {k}")
        _close(mu2[k], jmu[k], TOL["float32"], f"mu {k}")
        _blocks_as_specs(p2[k], pspec[k], f"param {k}")
        _blocks_as_specs(mu2[k], mspec[k], f"mu {k}")
        _blocks_as_specs(nu2[k], mspec[k], f"nu {k}")
        if "data" in str(tuple(mspec[k])) and \
                "data" not in str(tuple(pspec[k])):
            # ZeRO-2: half of the moment a device, the whole parameter
            # block
            assert mu2[k].locals[0].numel() * 2 == p2[k].locals[0].numel()
            split += 1
    assert split > 0
    if rules == "fsdp_tp":
        assert "data" in str(tuple(pspec["layers/mlp/wi_gate"]))
    assert all(int(t) == 1 for t in shd.local_tensors(dp.opt_state.step))


# ------------------------------------------------- forward and decode

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(2, 2), (2, 1, 2)])
def test_forward_cache_and_decode_over_data_rows_match_the_reference(
        shape, dtype, request):
    if dtype == "float32":
        request.getfixturevalue("f32_models")
    jm, jp, flat = _reference(7, dtype)
    mesh = _mesh(shape)
    ctx = make_ctx(mesh, "tp")
    model = build_model(CFG)
    tp = shd.device_put(convert.params_from_reference(flat, CFG),
                        shd.tree_shardings(model.logical_axes(), mesh,
                                           ctx.rules, model.param_specs()))
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, CFG.vocab_size, (B, P_LEN)).astype(np.int32)
    forced = rng.integers(0, CFG.vocab_size, (B, N_NEW)).astype(np.int32)
    tol = TOL[dtype]
    jlog, _, jc = jm.forward(jp, {"tokens": jnp.asarray(prompt)},
                             return_cache=True)
    tlog, _, tc = model.forward(tp, {"tokens": torch.from_numpy(prompt)
                                     .long()}, return_cache=True, ctx=ctx)
    assert isinstance(tlog, list) and len(tlog) == 2
    _close(row_logits(ctx, tlog, B), jlog, tol, "prefill logits")
    for k in ("k", "v"):
        assert tc[k].locals[0].shape[1] == B // 2      # the batch's block
        _close(tc[k], jc[k], tol, f"cache {k}")
    jc, tc = j_pad_cache(jc, N_NEW), trollout._pad_cache(tc, N_NEW)
    for i in range(N_NEW):
        tok = forced[:, i:i + 1]
        jlog, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(tok)})
        tlog, tc = model.decode_step(tp, tc, {"tokens": torch.from_numpy(
            tok).long()}, ctx=ctx)
        _close(row_logits(ctx, tlog, B), jlog, tol, f"decode {i}")
    _close(tc["k"], jc["k"], tol, "cache k after decode")


# ------------------------------------- the context-parallel decode

def test_zamba2_context_parallel_decode_matches_the_reference(monkeypatch):
    """reduced zamba2 (two shared-attention applications), B = 1, a cache
    of 8 slots split over ``data`` = 2 (4 a device) under ``long``: the
    prompt of 3 leaves the second block without a live key for the first
    step; each step's logits against the reference's ``decode_step``
    (op by op) and against the port on one device."""
    cfg, jcfg = reduced_config("zamba2-7b"), j_reduced_config("zamba2-7b")
    jm = j_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(3))
    flat = {k: np.asarray(v) for k, v in j_canonical_flat(jp, **IS_ARR)
            .items()}
    tm = build_model(cfg)
    params = convert.params_from_reference(flat, cfg)
    p_len, n_new = 3, 5
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, (1, p_len)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (1, n_new)).astype(np.int32)
    with jax.disable_jit():
        _, _, jc = jm.forward(jp, {"tokens": jnp.asarray(prompt)},
                              return_cache=True)
    _, _, tc = tm.forward(params, {"tokens": torch.from_numpy(prompt)
                                   .long()}, return_cache=True)
    jc, tc = j_pad_cache(jc, n_new), trollout._pad_cache(tc, n_new)
    mesh = _mesh((2, 1))
    ctx = make_ctx(mesh, "long")
    sp = shd.device_put(params, shd.tree_shardings(
        tm.logical_axes(), mesh, ctx.rules, tm.param_specs()))
    specs = tm.cache_specs(1, p_len + n_new)
    cp = dict(shd.device_put({k: v for k, v in tc.items() if k != "pos"},
                             shd.tree_shardings(common.logical_axes(specs),
                                                mesh, ctx.rules, specs)),
              pos=p_len)
    assert cp["attn_k"].sharding.spec[2] == "data"
    span = (p_len + n_new) // 2
    assert cp["attn_k"].locals[0].shape[2] == span
    one = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in tc.items()}
    calls = []
    real = kops.decode_attention

    def counted(*a, **kw):
        calls.append((a[3], kw.get("return_lse", False)))
        return real(*a, **kw)

    monkeypatch.setattr(kops, "decode_attention", counted)
    for i in range(n_new):
        tok = torch.from_numpy(forced[:, i:i + 1]).long()
        with jax.disable_jit():
            jlog, jc = jm.decode_step(
                jp, jc, {"tokens": jnp.asarray(forced[:, i:i + 1])})
        olog, one = tm.decode_step(params, one, {"tokens": tok})
        tlog, cp = tm.decode_step(sp, cp, {"tokens": tok}, ctx=ctx)
        tlog = row_logits(ctx, tlog, 1)
        _close(tlog, jlog, TOL["bfloat16"], f"step {i} vs reference")
        _close(tlog, olog, TOL["bfloat16"], f"step {i} vs one device")
    # the second block's first step saw no live key (a local pos below 0)
    assert (p_len - span, True) in calls
    assert cp["pos"] == p_len + n_new
    _close(cp["attn_k"], one["attn_k"], TOL["bfloat16"], "the cache's keys")


@pytest.mark.parametrize("pos", [-3, 0, 9, 15])
def test_plain_k2_lse_is_the_log_sum_exp_of_its_live_scores(pos):
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 6, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 16, 2, 16))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 16, 2, 16))
                         .astype(np.float32))
    out, lse = kref.ref_decode_attention(q, k, v, pos, scale=0.3,
                                         return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 6)
    if pos < 0:
        assert torch.all(lse == float("-inf")) and torch.all(out == 0)
        return
    scores = torch.einsum("bhd,bthd->bht", q,
                          torch.repeat_interleave(k, 3, dim=2)) * 0.3
    want = torch.logsumexp(scores[..., :pos + 1], dim=-1)
    assert torch.allclose(lse, want, atol=1e-5)
    assert torch.equal(out, kref.ref_decode_attention(q, k, v, pos,
                                                      scale=0.3))


# ---------------------------------------------------- the cost model

def _count(kind, rules, rows):
    cfg = reduced_config("qwen2-0.5b")
    model = build_model(cfg)
    mesh = _mesh((2, 2), META)
    ctx = make_ctx(mesh, rules, rows)
    n = ctx.size
    if kind == "train":
        shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16,
                                    global_batch=4)
        shs = ts.shardings(model, mesh, ctx.rules, zero=True)
        st = ts.abstract(model)
        st = ts.TrainState(
            shd.device_put(st.params, shs.params, n),
            topt.AdamWState(*(shd.device_put(getattr(st.opt_state, f),
                                             getattr(shs.opt_state, f), n)
                              for f in ("step", "mu", "nu"))),
            shd.device_put(st.step, shs.step, n))
        args, fn = (st, model.abstract_batch(shape)), \
            grpo.make_update_actor(model)
    else:
        params = shd.device_put(model.abstract_params(), shd.tree_shardings(
            model.logical_axes(), mesh, ctx.rules, model.param_specs()), n)
        if kind == "prefill":
            shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=16,
                                        global_batch=4)
            args, fn = (params, model.abstract_batch(shape)), \
                grpo.make_prefill(model)
        else:
            shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=16,
                                        global_batch=4)
            specs = model.cache_specs(4, 16)
            cache = dict(shd.device_put(common.abstract_params(specs),
                                        shd.tree_shardings(
                                            common.logical_axes(specs), mesh,
                                            ctx.rules, specs), n), pos=15)
            args, fn = (params, cache, model.abstract_batch(shape)), \
                grpo.make_decode(model)
    with hlo_cost.Counter() as c:
        fn(*args, ctx=ctx)
    return c.stats()


@pytest.mark.parametrize("kind,rules", [("train", "tp"),
                                        ("train", "fsdp_tp"),
                                        ("prefill", "tp"), ("decode", "tp")])
def test_one_rows_counts_equal_every_devices_of_a_meta_mesh(kind, rules):
    """Counts are sums over the devices: one data row's (the dry run's
    route on a production mesh) times the two rows equals every device's,
    exactly, in FLOPs, bytes, ops, each kernel's launches and work and
    each collective's bytes and count. The peak of live bytes is no sum
    (the rows run one after another here): one row's per device bounds
    every device's mean from above."""
    every, row = _count(kind, rules, None), _count(kind, rules, 1)

    def twice(x):
        return {k: twice(v) for k, v in x.items()} if isinstance(x, dict) \
            else 2 * x

    for key in ("flops", "traffic_bytes", "ops", "collective_bytes",
                "kernels", "collectives"):
        assert every[key] == twice(row[key]), key
    assert every["flops"] > 0 and every["collective_bytes"] > 0
    assert every["peak_live_bytes"] / 4 <= row["peak_live_bytes"] / 2


def test_dense_forward_collectives_are_their_closed_forms():
    """A forward without gradient on (2, 2) under ``tp``: every device
    receives the vocabulary-split embedding's all-reduce and two a layer
    (attention and MLP outputs), each (B/2, S, d) bf16; each row's first
    device receives its block of the logits (B/2, S, V) f32."""
    cfg = reduced_config("qwen2-0.5b")
    model = build_model(cfg)
    mesh = _mesh((2, 2), META)
    ctx = make_ctx(mesh, "tp")
    params = shd.device_put(model.abstract_params(), shd.tree_shardings(
        model.logical_axes(), mesh, ctx.rules, model.param_specs()))
    b, s = 4, 16
    tokens = torch.empty((b, s), dtype=torch.int32, device=META)
    with torch.no_grad(), hlo_cost.Counter() as c:
        model.forward(params, {"tokens": tokens}, ctx=ctx)
    coll = c.stats()["collectives"]
    act = (b // 2) * s * cfg.d_model * 2
    n_ar = 2 * cfg.num_layers + 1
    assert coll["all-reduce"] == {"bytes": 4 * n_ar * act, "count": 4 * n_ar}
    assert coll["all-gather"] == {
        "bytes": 2 * (b // 2) * s * cfg.vocab_size * 4, "count": 2}
    assert coll["reduce-scatter"]["count"] == 0
