"""mamba2 and zamba2 over a slice of virtual CPU devices (SSD heads split
over the slice), held against the JAX package's single-device functions.

The stored layouts are the reference's ``"tp"`` rules: ``in_proj``'s
columns (``ssm_inner``), the conv weights and conv cache (``conv_dim``),
the SSD heads' leaves and ssm cache (``ssm_heads``), ``norm`` and
``out_proj``'s rows. The first two split concatenated dims evenly, so
their blocks do not follow the heads: at ``reduced_config("mamba2-2.7b")``
(16 SSD heads of width 8, state 16, in_proj 304 = z 128 | x 128 | B 16 |
C 16 | dt 16, conv_dim 160) device 0 of 2 holds conv channels 0-79, the x
of heads 0-9, while its SSD heads are 0-7. ``models/mamba2.py`` gathers
the in_proj product, convolves each device's conv block, gathers that,
runs K3's
plain version at the local heads, all-reduces the gated norm's sum of
squares and the out_proj partial products. zamba2 (15 blocks: 2 shared-
attention applications, MHA 4 heads of width 16) runs its shared block
through the tensor-parallel layers.

The reference's seeded parameters are carried by canonical key and laid
out on the slice. Tolerances against the reference: bf16 5e-2 and f32
2e-3 of its largest magnitude. The f32 runs patch the embedding's bf16
cast out of both packages; zamba2's f32 case holds the prefill (its KV
cache and conv windows are bf16 on both sides' one-device paths).
"""
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.hybrid as jhybrid
import repro.models.mamba2 as jmamba2
from repro.configs import reduced_config as j_reduced_config
from repro.models import common as jcommon
from repro.models import sharding as jshd
from repro.models.common import canonical_flat as j_canonical_flat
from repro.models.registry import build_model as j_build_model
from repro.rl.rollout import _pad_cache as j_pad_cache
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import common, convert
from repro_torch.models import hybrid as thybrid
from repro_torch.models import layers as tl
from repro_torch.models import mamba2 as tmamba2
from repro_torch.models import sharding as shd
from repro_torch.models.registry import build_model
from repro_torch.rl import rollout as trollout
from test_torch_ep import (_FakeMesh, _ctx, close, laid_out,
                           migrate_and_sync_check, stored_specs_check,
                           train_batch, tuples, update_actor_check)

torch.set_num_threads(1)

CPU = torch.device("cpu")
MAMBA, ZAMBA = "mamba2-2.7b", "zamba2-7b"
TOL = {"float32": 2e-3, "bfloat16": 5e-2}
IS_ARR = dict(is_leaf=lambda x: hasattr(x, "shape"))
B, P_LEN, N_NEW = 2, 40, 4


# ------------------------------------------------------------ the specs

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_stored_specs_equal_the_reference(arch, n):
    _, params = stored_specs_check(arch, n)
    pre = "mamba_grouped/" if arch == ZAMBA else "layers/"
    for leaf in ("in_proj", "conv_w", "A_log", "norm", "out_proj"):
        v = params[f"{pre}mixer/{leaf}"]
        dim = {"in_proj": -1, "conv_w": -2}.get(leaf, -1)
        if leaf == "out_proj":
            dim = -2
        assert shd.splits(v, v.dim() + dim), leaf


def test_full_width_blocks_cross_the_heads():
    """mamba2-2.7b over 2 devices: in_proj 10,576 columns (5,288 a device:
    z and 168 columns of x on device 0), conv_dim 5,376 (2,688: 42 heads'
    x on device 0, 38 heads' x and B and C on device 1), 40 SSD heads a
    device; zamba2-7b's in_proj 14,576 (7,288), conv_dim 7,296 (3,648: 57
    heads' x), 56 heads."""
    for arch, cols, conv, heads, x_heads in ((MAMBA, 10_576, 5_376, 80, 42),
                                             (ZAMBA, 14_576, 7_296, 112, 57)):
        cfg = get_config(arch)
        assert tmamba2.in_proj_dim(cfg) == cols
        assert tmamba2.conv_dim(cfg) == conv and cfg.ssm_nheads == heads
        assert (conv // 2) // cfg.ssm_head_dim == x_heads != heads // 2
    assert tmamba2.in_proj_dim(get_config(MAMBA)) // 2 - 5_120 == 168


# ------------------------------------------------- forward and decode

def _f32_port_embed(p, cfg, tokens, ctx=None):
    if ctx is not None:
        return tl._embed_tp(p, cfg, tokens, ctx)
    return p["embedding"][tokens]


@pytest.fixture
def f32_port(monkeypatch):
    for mod in (tl, tmamba2, thybrid):
        monkeypatch.setattr(mod, "embed_apply", _f32_port_embed)


@contextlib.contextmanager
def _f32_reference():
    def embed(p, cfg, tokens, ctx=None):
        return p["embedding"][tokens]

    with mock.patch.object(jmamba2, "embed_apply", embed), \
            mock.patch.object(jhybrid, "embed_apply", embed):
        yield


_RUNS = {}


def _reference_run(arch, dtype, decode, seed=7):
    """The reduced JAX model on one device (memoised): its seeded params
    (cast to ``dtype``) as numpy leaves, a prompt and forced tokens, its
    prefill logits and cache, and its teacher-forced decode logits."""
    key = (arch, dtype, decode, seed)
    if key in _RUNS:
        return _RUNS[key]
    jm = j_build_model(j_reduced_config(arch))
    jp = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype))
                      if a.dtype == jnp.bfloat16 else a,
                      jm.init_params(jax.random.PRNGKey(seed)))
    flat = {k: np.asarray(v) for k, v in
            j_canonical_flat(jp, **IS_ARR).items()}
    rng = np.random.default_rng(seed + 1)
    prompt = rng.integers(0, jm.cfg.vocab_size, (B, P_LEN)).astype(np.int32)
    forced = rng.integers(0, jm.cfg.vocab_size, (B, N_NEW)).astype(np.int32)
    with contextlib.nullcontext() if dtype == "bfloat16" \
            else _f32_reference():
        log, _, cache = jm.forward(jp, {"tokens": jnp.asarray(prompt)},
                                   return_cache=True)
        logits = [np.asarray(log, np.float32)]
        kv = {k: np.asarray(v, np.float32) for k, v in cache.items()
              if k != "pos"}
        cache = j_pad_cache(cache, N_NEW)
        for i in range(N_NEW if decode else 0):
            log, cache = jm.decode_step(
                jp, cache, {"tokens": jnp.asarray(forced[:, i:i + 1])})
            logits.append(np.asarray(log, np.float32))
    _RUNS[key] = flat, prompt, forced, logits, kv
    return _RUNS[key]


def _port_params(flat, cfg, dtype):
    params = convert.params_from_reference(flat, cfg)
    if dtype == "float32":
        params = common.tree_map(lambda t: t.float(), params,
                                 is_leaf=torch.is_tensor)
    return params


def _cache_specs_of_the_reference(arch, n):
    jm = j_build_model(j_reduced_config(arch))
    jc = {k: v for k, v in jm.cache_specs(B, P_LEN).items() if k != "pos"}
    return tuples(jshd.tree_partition_specs(
        jcommon.logical_axes(jc), _FakeMesh({"data": 1, "model": n}),
        jshd.RULES_TP, jcommon.abstract_params(jc)))


CASES = [(a, n, d) for a in (MAMBA, ZAMBA) for n in (2, 4)
         for d in ("bfloat16", "float32")]


@pytest.mark.parametrize("arch,n,dtype", CASES,
                         ids=[f"{a.split('-')[0]}-{n}-{d}"
                              for a, n, d in CASES])
def test_ssm_forward_cache_and_decode_match_the_reference(arch, n, dtype,
                                                          request):
    if dtype == "float32":
        request.getfixturevalue("f32_port")
    decode = not (arch == ZAMBA and dtype == "float32")
    flat, prompt, forced, jlogits, jcache = _reference_run(arch, dtype,
                                                           decode)
    cfg = reduced_config(arch)
    model, ctx = build_model(cfg), _ctx(n)
    params = laid_out(model, _port_params(flat, cfg, dtype), ctx)
    tol = TOL[dtype]
    log, _, cache = model.forward(params, {"tokens": torch.from_numpy(
        prompt).long()}, return_cache=True, ctx=ctx)
    close(log, jlogits[0], tol, "prefill logits")
    assert log.device == CPU and cache["pos"] == P_LEN
    want_specs = _cache_specs_of_the_reference(arch, n)
    for k, v in jcache.items():
        assert isinstance(cache[k], shd.Sharded), k
        assert tuple(cache[k].sharding.spec) == want_specs[k], k
        if decode or k.startswith("ssm"):
            # the f32 SSM states within the bf16 tolerance of a state
            close(cache[k], v, tol, f"cache {k}")
    if not decode:
        return
    cache = trollout._pad_cache(cache, N_NEW)
    for i in range(N_NEW):
        log, cache = model.decode_step(params, cache, {
            "tokens": torch.from_numpy(forced[:, i:i + 1]).long()}, ctx=ctx)
        close(log, jlogits[i + 1], tol, f"decode {i}")
    assert cache["pos"] == P_LEN + N_NEW


@pytest.mark.parametrize("n", [2, 4])
def test_mixer_over_a_slice_matches_one_device(n):
    """The mixer over the slice in f32 (in_proj's product gathered, the
    conv blocks across head boundaries): the same outputs and prefill
    states as the one-device mixer within 1e-6, then one decode step on
    each device's cache blocks, in place."""
    cfg = reduced_config(MAMBA)
    flat = _reference_run(MAMBA, "float32", True)[0]
    mixer = {k.split("/")[-1]: torch.from_numpy(np.array(v[0])).float()
             for k, v in flat.items() if "/mixer/" in k}
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(
        (B, 12, cfg.d_model)).astype(np.float32))
    x1 = torch.from_numpy(rng.standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32))
    want, wst = tmamba2.mixer_apply(mixer, cfg, x, return_state=True)
    ctx = _ctx(n)
    specs = tmamba2.mixer_param_specs(cfg)
    p = shd.device_put(mixer, shd.tree_shardings(
        common.logical_axes(specs), ctx.mesh, ctx.rules, specs))
    out, st = tmamba2.mixer_apply(p, cfg, [x] * n, return_state=True,
                                  ctx=ctx)
    conv_split = shd.splits(p["conv_w"], 0)
    assert conv_split
    assert len(out) == n
    for o in out:
        close(o, want, 1e-6, "prefill")
    close(torch.cat(st["ssm"], dim=1), wst["ssm"], 1e-6, "ssm state")
    close(torch.cat(st["conv"], dim=1), wst["conv"], 1e-6, "conv state")
    want1, _ = tmamba2.mixer_apply(mixer, cfg, x1, cache=wst)
    out1, _ = tmamba2.mixer_apply(p, cfg, [x1] * n, cache=st, ctx=ctx)
    for o in out1:
        close(o, want1, 1e-6, "decode")
    close(torch.cat(st["ssm"], dim=1), wst["ssm"], 1e-6, "ssm after")
    close(torch.cat(st["conv"], dim=1), wst["conv"], 1e-6, "conv after")


def test_mixer_refuses_heads_that_do_not_divide_the_slice():
    cfg = reduced_config(MAMBA).replace(d_model=24)     # 6 SSD heads
    specs = tmamba2.mixer_param_specs(cfg)
    ctx = _ctx(4)
    params = shd.device_put(
        common.init_params(torch.Generator().manual_seed(0), specs, CPU),
        shd.tree_shardings(common.logical_axes(specs), ctx.mesh, ctx.rules,
                           specs))
    x = torch.zeros((1, 4, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="divides the heads"):
        tmamba2.mixer_apply(params, cfg, [x] * 4, ctx=ctx)


# ---------------------------------------------------------- training

@pytest.mark.parametrize("arch,n", [(MAMBA, 2), (MAMBA, 4), (ZAMBA, 2)])
def test_update_actor_over_a_slice_matches_one_device(arch, n, f32_port):
    """f32, the tied (mamba2) or input (zamba2) embedding scaled by 1/16:
    gradients through K3's Function's plain path on every device, the
    shared block's summed over its applications and its replicas."""
    flat = dict(_reference_run(arch, "float32", arch == MAMBA)[0])
    flat["embed/embedding"] = flat["embed/embedding"] / 16
    params = _port_params(flat, reduced_config(arch), "float32")
    keys = [k for k in common.canonical_flat(params)
            if k.endswith(("in_proj", "conv_w", "A_log", "out_proj",
                           "attn/wq"))]
    update_actor_check(arch, n, params, train_batch(6, 128), keys)


def test_mamba2_job_migrates_across_slices_and_syncs_bit_exact():
    migrate_and_sync_check(MAMBA)
