"""gemma2, whisper and the vlm family over a slice of virtual CPU devices,
held against the JAX package's single-device functions.

The reference lays a group's state out on its slice under the ``"tp"``
rules and lets GSPMD partition every op; the port runs the same layout by
hand: K1 and K2 at each device's local heads, cross-attention projecting
q from the residual stream and k, v from the encoder output or the patch
embeddings (both on every device), the cross K/V kept per device in the
cross cache's layout, the cross decode K2 over each device's block, the
biased MLP column- then row-parallel with its output bias added once,
gemma2's post-norms on the all-reduced outputs and vision's gates on
every device.

At ``reduced_config``: gemma2 (4 layers, window 8, softcaps 50 and 30,
GQA 4:2 of width 16, vocab 128), whisper (2 + 2 layers, MHA 4:4 of width
16, encoder_seq 12) and llama-3.2-vision (10 layers in 2 groups, GQA 4:2,
vision_seq 9). model = 2 splits every head count; model = 4 splits
whisper's 4 KV heads, while gemma2's and vision's 2 KV heads do not
split and their caches, the cross K/V too, split over head_dim: the self
decode and the cross decode take the head-dim-parallel route.

The reference's seeded parameters are carried by canonical key
(``models/convert.py``) and laid out on the slice; vision's gates are set
nonzero first (zero gates hide the cross path). Frames are at the
reference's ``dummy_batch`` scale 0.02, patch embeddings at unit scale,
the same bits on both sides. Tolerances against the reference: bf16 5e-2
and f32 2e-3 of its largest magnitude; the f32 runs patch the embedding's
bf16 cast out of both packages (gemma's scale kept).
"""
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jtransformer
import repro.models.vision as jvision
import repro.models.whisper as jwhisper
from repro.configs import reduced_config as j_reduced_config
from repro.models import common as jcommon
from repro.models import sharding as jshd
from repro.models.common import canonical_flat as j_canonical_flat
from repro.models.registry import build_model as j_build_model
from repro.rl.rollout import _pad_cache as j_pad_cache
from repro_torch.configs import reduced_config
from repro_torch.core.state_manager import StateManager
from repro_torch.launch.mesh import DevicePlane
from repro_torch.models import common, convert
from repro_torch.models import layers as tl
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as ttransformer
from repro_torch.models import vision as tvision
from repro_torch.models import whisper as twhisper
from repro_torch.models.registry import build_model
from repro_torch.rl import rollout as trollout
from test_torch_ep import (_FakeMesh, _ctx, close, laid_out,
                           migrate_and_sync_check, stored_specs_check,
                           train_batch, tuples, update_actor_check)
from test_torch_remat import _f32_embed

torch.set_num_threads(1)

CPU = torch.device("cpu")
GEMMA, WHISPER, VISION = "gemma2-27b", "whisper-large-v3", \
    "llama-3.2-vision-90b"
ARCHS = (GEMMA, WHISPER, VISION)
TOL = {"float32": 2e-3, "bfloat16": 5e-2}
IS_ARR = dict(is_leaf=lambda x: hasattr(x, "shape"))
GATE = 0.5
B, P_LEN, N_NEW = 2, 12, 4       # gemma2's window of 8 cuts in both


# ----------------------------------------------------------- the inputs

def _extra(arch, dtype, seed, b=B):
    """The inputs beside the tokens, as numpy arrays of the bits both
    sides read: whisper's frames at 0.02, vision's patch embeddings at
    unit scale (bf16 values, f32 in an f32 run)."""
    cfg = reduced_config(arch)
    if cfg.family == "dense":
        return {}
    name, t, scale = ("frames", cfg.encoder_seq, 0.02) \
        if cfg.family == "audio" else ("vision", cfg.vision_seq, 1.0)
    arr = np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)) * scale
    arr = np.asarray(jnp.asarray(arr, jnp.float32).astype(jnp.bfloat16))
    return {name: arr.astype(np.float32) if dtype == "float32" else arr}


def _t(arr):
    return convert.tensor_from_numpy(np.asarray(arr))


def _f32_port_embed(p, cfg, tokens, ctx=None):
    """The port's ``embed_apply`` without the bf16 cast (gemma's scale
    kept); over a slice the vocabulary-parallel lookup, which calls this
    per device."""
    if ctx is not None:
        return tl._embed_tp(p, cfg, tokens, ctx)
    return _f32_embed(p, cfg, tokens)


@pytest.fixture
def f32_port(monkeypatch):
    for mod in (tl, ttransformer, twhisper, tvision):
        monkeypatch.setattr(mod, "embed_apply", _f32_port_embed)


@contextlib.contextmanager
def _f32_reference():
    with mock.patch.object(jtransformer, "embed_apply", _f32_embed), \
            mock.patch.object(jwhisper, "embed_apply", _f32_embed), \
            mock.patch.object(jvision, "embed_apply", _f32_embed):
        yield


_RUNS = {}


def _reference_run(arch, dtype, seed=7):
    """The reduced JAX model on one device (memoised): its seeded params
    (cast to ``dtype``; vision's gates at GATE) as numpy leaves, a
    prompt, forced tokens, the extra inputs, its prefill logits and cache
    and its teacher-forced decode logits and cache."""
    key = (arch, dtype, seed)
    if key in _RUNS:
        return _RUNS[key]
    jm = j_build_model(j_reduced_config(arch))
    jp = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype))
                      if a.dtype == jnp.bfloat16 else a,
                      jm.init_params(jax.random.PRNGKey(seed)))
    if arch == VISION:
        for g in ("gate_attn", "gate_mlp"):
            jp["cross_layers"][g] = jnp.full_like(jp["cross_layers"][g],
                                                  GATE)
    flat = {k: np.asarray(v) for k, v in
            j_canonical_flat(jp, **IS_ARR).items()}
    rng = np.random.default_rng(seed + 1)
    vocab = jm.cfg.vocab_size
    prompt = rng.integers(0, vocab, (B, P_LEN)).astype(np.int32)
    forced = rng.integers(0, vocab, (B, N_NEW)).astype(np.int32)
    extra = _extra(arch, dtype, seed + 2)
    with contextlib.nullcontext() if dtype == "bfloat16" \
            else _f32_reference():
        log, _, cache = jm.forward(
            jp, {"tokens": jnp.asarray(prompt),
                 **{k: jnp.asarray(v) for k, v in extra.items()}},
            return_cache=True)
        logits = [np.asarray(log, np.float32)]
        prefill = {k: np.asarray(v, np.float32) for k, v in cache.items()
                   if k != "pos"}
        cache = j_pad_cache(cache, N_NEW)
        for i in range(N_NEW):
            log, cache = jm.decode_step(
                jp, cache, {"tokens": jnp.asarray(forced[:, i:i + 1])})
            logits.append(np.asarray(log, np.float32))
        decoded = {k: np.asarray(cache[k], np.float32) for k in ("k", "v")}
    _RUNS[key] = (jm, flat, prompt, forced, extra, logits, prefill, decoded)
    return _RUNS[key]


def _port_params(flat, cfg, dtype):
    params = convert.params_from_reference(flat, cfg)
    if dtype == "float32":
        params = common.tree_map(lambda t: t.float(), params,
                                 is_leaf=torch.is_tensor)
    return params


# ------------------------------------------------------------ the specs

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_stored_specs_equal_the_reference(arch, n):
    """The params' and AdamW moments' specs and per-device shapes on an
    n-device slice (reduced, allocated; full width from the specs) equal
    the reference's; the heads, ``mlp`` and the vocabulary split where
    they divide the slice."""
    _, params = stored_specs_check(arch, n)
    cfg = reduced_config(arch)
    attn = {GEMMA: "layers/attn", WHISPER: "layers/cross_attn",
            VISION: "cross_layers/attn"}[arch]
    # (layers, d_model, heads, head_dim) and (layers, d_ff, d_model)
    assert shd.splits(params[f"{attn}/wq"], 2)
    assert shd.splits(params[f"{attn}/wk"], 2) == \
        (cfg.num_kv_heads % n == 0)
    mlp = "cross_layers/mlp" if arch == VISION else "layers/mlp"
    assert shd.splits(params[f"{mlp}/wo"], 1)
    assert shd.splits(params["embed/embedding"], 0)
    if arch == WHISPER:
        # the biased MLP: wi and bi column-parallel, bo replicated
        assert shd.splits(params["layers/mlp/bi"], 1)
        assert tuple(params["layers/mlp/bo"].sharding.spec) == ()
    if arch == VISION:
        assert tuple(params["cross_layers/gate_attn"].sharding.spec) == ()


# ------------------------------------------------- forward and decode

def _cache_specs_check(model, cache, n, b, s):
    """The cache a prefill built, entry by entry, in the reference's
    resolution of its cache specs on a (1, n) mesh."""
    jc = j_build_model(j_reduced_config(model.cfg.name)).cache_specs(b, s)
    jc = {k: v for k, v in jc.items() if k != "pos"}
    want = tuples(jshd.tree_partition_specs(
        jcommon.logical_axes(jc), _FakeMesh({"data": 1, "model": n}),
        jshd.RULES_TP, jcommon.abstract_params(jc)))
    assert {k: tuple(cache[k].sharding.spec) for k in want} == want


def _counting(fn, calls):
    def wrapped(*a, **kw):
        calls.append(fn.__name__)
        return fn(*a, **kw)

    return wrapped


CASES = [(a, n, d) for a in ARCHS for n in (2, 4)
         for d in ("bfloat16", "float32")]


@pytest.mark.parametrize("arch,n,dtype", CASES,
                         ids=[f"{a.split('-')[0]}-{n}-{d}"
                              for a, n, d in CASES])
def test_forward_cache_and_decode_match_the_reference(arch, n, dtype,
                                                      request):
    """The prefill's logits and every cache entry (whisper's and vision's
    cross K/V too, in the reference's layout), ``_pad_cache`` growing the
    self cache's locals and leaving the cross K/V, then teacher-forced
    decode steps (gemma2's window past 8 tokens). Where the KV heads do
    not split (gemma2 and vision at n = 4) every decode step's self and
    cross attention goes through the head-dim-parallel route."""
    if dtype == "float32":
        request.getfixturevalue("f32_port")
    _, flat, prompt, forced, extra, jlogits, jpre, jdec = \
        _reference_run(arch, dtype)
    cfg = reduced_config(arch)
    model, ctx = build_model(cfg), _ctx(n)
    params = laid_out(model, _port_params(flat, cfg, dtype), ctx)
    tol = TOL[dtype]
    batch = {"tokens": torch.from_numpy(prompt).long(),
             **{k: _t(v) for k, v in extra.items()}}
    log, aux, cache = model.forward(params, batch, return_cache=True,
                                    ctx=ctx)
    close(log, jlogits[0], tol, "prefill logits")
    assert log.device == CPU and cache["pos"] == P_LEN and float(aux) == 0
    _cache_specs_check(model, cache, n, B, P_LEN)
    assert set(cache) == set(jpre) | {"pos"}
    for k, v in jpre.items():
        assert isinstance(cache[k], shd.Sharded), k
        close(cache[k], v, tol, f"cache {k}")
    hd = tl.hd_parallel(cfg, ctx)
    assert hd == (n == 4 and arch != WHISPER)
    cross = {k: cache[k] for k in ("cross_k", "cross_v") if k in cache}
    if hd:
        for k in ("k",) + tuple(cross):
            assert shd.splits(cache[k], cache[k].dim() - 1), k
    cache = trollout._pad_cache(cache, N_NEW)
    assert cache["k"].shape[-3] == P_LEN + N_NEW
    for k, v in cross.items():
        assert cache[k] is v, k
    calls = []
    with mock.patch.object(tl, "_hd_decode_tp",
                           _counting(tl._hd_decode_tp, calls)):
        for i in range(N_NEW):
            log, cache = model.decode_step(params, cache, {
                "tokens": torch.from_numpy(forced[:, i:i + 1]).long()},
                ctx=ctx)
            close(log, jlogits[i + 1], tol, f"decode {i}")
    attn_layers = cfg.num_layers if arch != WHISPER else 2 * cfg.num_layers
    assert len(calls) == (N_NEW * attn_layers if hd else 0)
    for k, v in jdec.items():
        close(cache[k], v, tol, f"cache {k} after decode")
    assert cache["pos"] == P_LEN + N_NEW


def test_greedy_rollout_with_extra_inputs_equals_one_device_in_f32(
        f32_port):
    """A greedy rollout of each family over 2 and over 4 devices, the
    frames or patch embeddings given as ``extra_inputs``, picks the
    one-device rollout's tokens (f32: the partial sums move the logits by
    ~1e-6)."""
    cfg_rollout = trollout.RolloutConfig(max_new_tokens=6, greedy=True)
    gen = torch.Generator().manual_seed(0)
    for arch in ARCHS:
        _, flat, prompt, _, extra, _, _, _ = _reference_run(arch, "float32")
        cfg = reduced_config(arch)
        model = build_model(cfg)
        params = _port_params(flat, cfg, "float32")
        prompt = torch.from_numpy(prompt).long()
        extra = {k: _t(v) for k, v in extra.items()}
        want, wlp, _ = trollout.rollout(model, params, prompt, gen,
                                        cfg_rollout, extra_inputs=extra)
        for n in (2, 4):
            ctx = _ctx(n)
            got, glp, _ = trollout.rollout(model, laid_out(model, params, ctx),
                                           prompt, gen, cfg_rollout,
                                           extra_inputs=extra, ctx=ctx)
            assert torch.equal(got, want), (arch, n)
            close(glp, wlp, 1e-4, f"{arch} logprobs {n}")


@pytest.mark.parametrize("n", [2, 4])
def test_biased_mlp_over_a_slice_adds_its_output_bias_once(n):
    """whisper's MLP in f32 over the slice against one device: ``wi`` and
    ``bi`` column-parallel, ``wo`` row-parallel, and ``bo`` (replicated,
    at unit scale: added n times it would move the output by (n - 1) *
    |bo|) added once, after the all-reduce; every device holds the same
    bits."""
    cfg = reduced_config(WHISPER)
    specs = tl.mlp_param_specs(cfg, cfg.d_ff)
    rng = np.random.default_rng(5)
    p = {k: torch.from_numpy(rng.standard_normal(sp.shape).astype(
        np.float32) * (1.0 if k.startswith("b") else 0.1))
        for k, sp in specs.items()}
    x = torch.from_numpy(rng.standard_normal((B, 7, cfg.d_model)).astype(
        np.float32))
    want = tl.mlp_apply(p, cfg, x)
    ctx = _ctx(n)
    sh = shd.tree_shardings(common.logical_axes(specs), ctx.mesh, ctx.rules,
                            specs)
    sp = shd.device_put(p, sh)
    assert shd.splits(sp["wi"], 1) and shd.splits(sp["bi"], 0)
    assert shd.splits(sp["wo"], 0) and tuple(sp["bo"].sharding.spec) == ()
    got = tl.mlp_apply(sp, cfg, [x] * n, ctx)
    assert len(got) == n and all(torch.equal(g, got[0]) for g in got)
    assert float(p["bo"].abs().max()) > 1.0
    close(got[0], want, 1e-5, "biased mlp")


def test_cross_decode_over_a_slice_matches_one_device():
    """``cross_decode`` in f32 over the slice against one device at
    vision's reduced 4:2 heads: at n = 2 K2's route at the local heads, at
    n = 4 the head-dim-parallel route over the cross K/V's head_dim
    blocks, every key live."""
    cfg = reduced_config(VISION)
    specs = tl.attn_param_specs(cfg)
    rng = np.random.default_rng(9)
    p = {k: torch.from_numpy(rng.standard_normal(sp.shape).astype(
        np.float32) * 0.3) for k, sp in specs.items()}
    t, kh, hd = cfg.vision_seq, cfg.num_kv_heads, cfg.resolved_head_dim
    h = torch.from_numpy(rng.standard_normal((B, 1, cfg.d_model)).astype(
        np.float32))
    ck, cv = (torch.from_numpy(rng.standard_normal((B, t, kh, hd)).astype(
        np.float32)) for _ in range(2))
    want = tl.cross_decode(p, cfg, h, ck, cv)
    for n in (2, 4):
        ctx = _ctx(n)
        sp = shd.device_put(p, shd.tree_shardings(
            common.logical_axes(specs), ctx.mesh, ctx.rules, specs))
        csh = shd.NamedSharding(ctx.mesh, shd.resolve(
            ("cache_batch", None, "kv_heads", "cache_hd"), ctx.mesh,
            ctx.rules, shape=ck.shape))
        blocks = [shd.shard(c, csh).locals for c in (ck, cv)]
        assert tl.hd_parallel(cfg, ctx) == (n == 4)
        got = tl.cross_decode(sp, cfg, [h] * n, *blocks, ctx)
        assert len(got) == n
        for g in got:
            close(g, want, 1e-5, f"cross decode over {n}")


# ---------------------------------------------------------- training

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_update_actor_over_a_slice_matches_one_device(arch, n, f32_port):
    """One f32 UPDATE_ACTOR under ``remat`` with the frames or patch
    embeddings in the batch (tied embedding or unembedding scaled by 1/16:
    a spread policy): metrics, first moments and parameters against one
    device (``update_actor_check``); the cross-attention's weights and
    vision's gates moved."""
    flat = dict(_reference_run(arch, "float32")[1])
    emb = "embed/unembed" if arch == VISION else "embed/embedding"
    flat[emb] = flat[emb] / 16
    cfg = reduced_config(arch)
    assert cfg.remat == "full"
    batch = dict(train_batch(6, cfg.vocab_size),
                 **_extra(arch, "float32", 11, b=4))
    keys = ("layers/cross_attn/wq", "layers/cross_attn/wk",
            "layers/mlp/bo", "enc_layers/attn/wv") if arch == WHISPER else \
        ("cross_layers/attn/wq", "cross_layers/attn/wk",
         "cross_layers/gate_attn", "cross_layers/gate_mlp")
    update_actor_check(arch, n, _port_params(flat, cfg, "float32"), batch,
                       keys)


def test_gate_write_reaches_every_replica():
    """``StateManager.write`` of vision's gates into their ``Sharded``
    replicated leaves on a 4-device slice: every device's copy holds the
    written values."""
    cfg = reduced_config(VISION)
    sl = DevicePlane(devices=[CPU] * 4, slice_size=4).slice_for_group(0)
    sm = StateManager(mesh_slice=sl)
    model = build_model(cfg)
    params = laid_out(model, model.init_params(torch.Generator()
                                               .manual_seed(0)),
                      tl.make_ctx(sl.mesh))
    sm.register("J", params)
    gates = torch.tensor([0.25, -0.75])
    sm.write("J", {"cross_layers": {"gate_attn": gates}})
    leaf = sm.gather("J", model.param_specs())["cross_layers"]["gate_attn"]
    assert isinstance(leaf, shd.Sharded) and len(leaf.locals) == 4
    for loc in leaf.locals:
        assert torch.equal(loc, gates)


# --------------------------------------------- migration and weight sync

def test_whisper_job_migrates_across_slices_and_syncs_bit_exact():
    migrate_and_sync_check(WHISPER, {
        k: _t(v) for k, v in _extra(WHISPER, "bfloat16", 3, b=4).items()})
