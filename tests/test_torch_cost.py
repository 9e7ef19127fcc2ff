"""The port's cost model and dry run, held against the JAX package.

- The registry's abstract inputs: for all 13 configs at full width the
  ``meta`` parameters, train state and cache match the reference's
  ``abstract_params`` / ``train_state.abstract`` / ``abstract_cache`` leaf
  by canonical key in shape and dtype, ``param_count`` and
  ``active_param_count`` are exact, and ``input_specs`` match for every
  shape kind; ``dummy_batch`` matches in shapes, dtypes and ranges.
- ``launch/hlo_cost``: a matmul counts 2·M·K·N (``tests/test_hlo_cost.py``);
  K1, K2 and K3 count the work of PERF.md's bound column through their
  wrappers' meta route; each family's reduced prefill, decode step and
  ``update_actor`` count the same on ``meta`` and on the CPU, exactly; a
  reduced forward's FLOPs equal the reference's ``hlo_cost.analyze`` of
  its compiled forward within 1 %, once the query-key pairs K1's count
  leaves out (the causal half, the window) and the reference's XLA
  attention computes are added back by closed form.
- ``launch/dryrun.run_cell`` completes at full width for seven cells; two
  cells' outputs equal the reference's ``jax.eval_shape`` of the step;
  ``fits_one_card`` is the reference's per-device sum (arguments +
  temporaries + outputs - aliases) within 80 GB, a train cell's
  temporaries those of the reference's ``default_grad_accum`` microbatch.
- The production meshes (``run_mesh_cell``, ``main``'s ``--both-meshes``,
  ``--multi-pod`` and ``--rules``): four cells' per-device argument bytes
  equal the sum over the reference's specs of each leaf's bytes over its
  split, and their mesh FLOPs the one card's plus the products the rules
  replicate (closed form, 1 %); a reduced forward's per-device FLOPs on a
  (2, 2) ``meta`` mesh equal the reference's compiled HLO on four forced
  host devices (a child process) within 1 %.
- ``hlo_cost``'s live bytes: exact on a hand-counted chain of matmuls, a
  kernel call counted by its outputs, and the same peak on ``meta`` and on
  the CPU for each family's reduced steps (head width 16 through the
  plain routes); beside XLA's ``memory_analysis()`` of the
  reference's compiled reduced steps the arguments agree and the
  temporaries are printed (``-s``), not held (XLA fuses and reuses).
"""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.launch import dryrun as jdryrun
from repro.launch import hlo_cost as jcost
from repro.models.common import canonical_flat as jflat
from repro.models.registry import build_model as jbuild
from repro.rl import grpo as jgrpo
from repro.train import train_state as jts
from repro_torch.configs import SHAPES, ShapeSpec, list_configs
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import ops as kops
from repro_torch.launch import dryrun, hlo_cost, mesh
from repro_torch.models import common
from repro_torch.models import sharding as shd
from repro_torch.models.registry import build_model
from repro_torch.rl import grpo
from repro_torch.train import train_state as ts

torch.set_num_threads(2)


def _jleaves(tree):
    return {k: (tuple(v.shape), str(jnp.dtype(v.dtype)))
            for k, v in jflat(tree, is_leaf=lambda x: hasattr(x, "shape")
                              ).items()}


def _tleaves(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in common.canonical_flat(
                tree, is_leaf=torch.is_tensor).items()}


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------------------------- registry

@pytest.mark.parametrize("arch", list_configs())
def test_abstract_inputs_match_the_reference(arch):
    jm, tm = jbuild(jget_config(arch)), build_model(get_config(arch))
    assert _tleaves(tm.abstract_params()) == _jleaves(jm.abstract_params())
    assert all(t.device.type == "meta" for t in common.canonical_flat(
        tm.abstract_params(), is_leaf=torch.is_tensor).values())
    assert tm.param_count() == jm.param_count()
    assert tm.active_param_count() == jm.active_param_count()
    jstate, tstate = jts.abstract(jm), ts.abstract(tm)
    for part in ("mu", "nu"):
        assert _tleaves(getattr(tstate.opt_state, part)) == \
            _jleaves(getattr(jstate.opt_state, part))
    assert _tleaves({"s": tstate.step}) == _jleaves({"s": jstate.step})
    # the port's cache keeps pos as a host int, the reference an int32 leaf
    jcache = _jleaves(jm.abstract_cache(2, 64))
    assert jcache.pop("pos") == ((), "int32")
    tcache = tm.abstract_cache(2, 64, pos=5)
    assert tcache.pop("pos") == 5
    assert _tleaves(tcache) == jcache
    for shape in SHAPES.values():
        for rl_train in (True, False):
            js = jm.input_specs(shape, rl_train)
            tspecs = tm.input_specs(shape, rl_train)
            assert list(tspecs) == list(js)
            for k, sp in tspecs.items():
                assert sp.shape == js[k].sds.shape, (k, shape)
                assert str(sp.dtype) == f"torch.{jnp.dtype(js[k].sds.dtype)}"
                assert sp.axes == js[k].axes


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-90b"])
def test_dummy_batch_and_init_cache_match_the_reference_in_kind(arch):
    jm, tm = jbuild(jreduced(arch)), build_model(reduced_config(arch))
    shape = ShapeSpec("t", "train", 12, 4)
    jb = jm.dummy_batch(jax.random.PRNGKey(0), shape)
    tb = tm.dummy_batch(torch.Generator().manual_seed(0), shape)
    assert list(tb) == list(jb)
    for k, v in tb.items():
        assert tuple(v.shape) == jb[k].shape
        assert str(v.dtype) == f"torch.{jnp.dtype(jb[k].dtype)}"
    vocab = tm.cfg.vocab_size
    assert 0 <= int(tb["tokens"].min()) and int(tb["tokens"].max()) < vocab
    assert bool((tb["behavior_logprobs"] <= 0).all())
    assert bool((tb["loss_mask"] == 1).all())
    extra = tb["frames" if "frames" in tb else "vision"].float()
    assert 0.01 < float(extra.std()) < 0.03
    cache = tm.init_cache(torch.Generator().manual_seed(0), 2, 16)
    assert cache.pop("pos") == 0
    assert all(not bool(v.any()) for v in cache.values())
    assert _tleaves(cache) == {k: v for k, v in _jleaves(
        jm.abstract_cache(2, 16)).items() if k != "pos"}


# ------------------------------------------------------------ the counter

def test_matmul_counts_2mkn_on_every_device():
    M, K, N = 64, 128, 32
    for dev in ("cpu", "meta"):
        a, b = torch.randn(M, K).to(dev), torch.randn(K, N).to(dev)
        res = hlo_cost.analyze(lambda: a @ b)
        assert res["flops"] == 2 * M * K * N
        assert res["traffic_bytes"] == (M * K + K * N + M * N) * 4
        assert res["collective_bytes"] == 0


def test_kernel_work_is_perf_md_bound_column():
    """PERF.md §6: qwen2 K1 8.39 MB and 0.473 GFLOP, K2 1.63 MB and 11.0
    MFLOP, mamba2 K3 216.5 MB and 53.8 GFLOP, counted through the
    wrappers' meta route (no launch: LAUNCHES is unchanged)."""
    before = dict(kops.LAUNCHES)
    q, k = _meta(16, 128, 14, 64), _meta(16, 128, 2, 64)
    k1 = hlo_cost.analyze(lambda: kops.flash_attention(q, k, k))
    qd, kc = _meta(16, 14, 64), _meta(16, 192, 2, 64)
    k2 = hlo_cost.analyze(lambda: kops.decode_attention(qd, kc, kc, 191))
    x, dt = _meta(16, 512, 80, 64), _meta(16, 512, 80, dtype=torch.float32)
    A, Bm = _meta(80, dtype=torch.float32), _meta(16, 512, 1, 128)
    k3 = hlo_cost.analyze(lambda: kops.ssd(x, dt, A, Bm, Bm, chunk=256))
    assert kops.LAUNCHES == before
    for res, name, nbytes, flops in (
            (k1, "flash_attention", 8.39e6, 0.473e9),
            (k2, "decode_attention", 1.63e6, 11.0e6),
            (k3, "ssd", 216.5e6, 53.8e9)):
        work = res["kernels"][name]
        assert work["launches"] == 1 and res["ops"] == 0
        assert (res["flops"], res["traffic_bytes"]) == \
            (work["flops"], work["bytes"])
        assert float(f"{work['bytes']:.4g}") == pytest.approx(nbytes,
                                                              rel=5e-3)
        assert float(f"{work['flops']:.3g}") == flops
    assert k1["kernels"]["flash_attention"]["flops"] == 473_432_064
    assert k3["kernels"]["ssd"]["bytes"] == 216_531_264


def test_meta_route_returns_the_kernels_shapes():
    q, k = _meta(2, 5, 4, 64), _meta(2, 7, 2, 64)
    out = kops.flash_attention(q, k, k, causal=False)
    assert (out.device.type, out.shape, out.dtype) == ("meta", q.shape,
                                                       q.dtype)
    assert out.is_contiguous()
    out = kops.decode_attention(_meta(2, 4, 64), k, k, 6)
    assert (out.shape, out.dtype) == ((2, 4, 64), torch.bfloat16)
    y, st = kops.ssd(_meta(2, 9, 3, 8), _meta(2, 9, 3, dtype=torch.float32),
                     _meta(3, dtype=torch.float32), _meta(2, 9, 1, 16),
                     _meta(2, 9, 1, 16), chunk=4)
    assert (y.shape, y.dtype) == ((2, 9, 3, 8), torch.bfloat16)
    assert (st.shape, st.dtype) == ((2, 3, 8, 16), torch.float32)
    assert kops.flash_attention_work(1, 4, 4, 1, 1, 1, 2, window=2)[0] == \
        4 * (1 + 2 + 2 + 2)


def test_live_bytes_of_a_matmul_chain_are_exact():
    """Known live sets: b, then b and c (the peak, two 64 x 64 f32 tiles),
    c and d, d and e; a view and an in-place op add nothing, and what the
    function returns stays live until it is dropped."""
    tile = 64 * 64 * 4
    for dev in ("cpu", "meta"):
        a = torch.ones(64, 64, device=dev)        # an argument: not counted

        def chain():
            b = a @ a
            c = b @ a
            del b
            d = c @ a
            d.t().add_(1.0)
            del c
            e = torch.relu(d)
            del d
            return e

        with hlo_cost.Counter() as counter:
            out = chain()
        assert counter.stats()["peak_live_bytes"] == 2 * tile, dev
        assert counter.memory.live == tile
        del out
        assert counter.memory.live == 0


def test_live_bytes_count_a_kernel_call_by_its_outputs():
    """The plain version's scores on the CPU are not counted, nor anything
    on ``meta``: a K1 call adds its output, on either device."""
    for dev in ("cpu", "meta"):
        q = torch.ones(2, 40, 4, 16, dtype=torch.bfloat16, device=dev)
        k = torch.ones(2, 40, 2, 16, dtype=torch.bfloat16, device=dev)
        with hlo_cost.Counter() as counter:
            out = kops.flash_attention(q, k, k)
        assert counter.stats()["peak_live_bytes"] == q.numel() * 2, dev
        del out


def _steps(model, device):
    """(update_actor, prefill, decode) stats of one model on ``device``:
    seeded tensors on the CPU, ``meta`` tensors else."""
    sh_t, sh_p = ShapeSpec("t", "train", 16, 4), ShapeSpec("p", "prefill",
                                                           16, 2)
    sh_d = ShapeSpec("d", "decode", 24, 2)
    if device == "meta":
        state, batches = ts.abstract(model), [
            model.abstract_batch(s) for s in (sh_t, sh_p, sh_d)]
        cache = model.abstract_cache(2, 24, pos=23)
    else:
        g = torch.Generator().manual_seed(0)
        state = ts.init(model, g)
        batches = [model.dummy_batch(g, s) for s in (sh_t, sh_p, sh_d)]
        cache = dict(model.init_cache(g, 2, 24), pos=23)
    stats = [hlo_cost.analyze(grpo.make_update_actor(model), state,
                              batches[0]),
             hlo_cost.analyze(grpo.make_prefill(model), state.params,
                              batches[1]),
             hlo_cost.analyze(grpo.make_decode(model), state.params, cache,
                              batches[2])]
    return [{k: s[k] for k in ("flops", "traffic_bytes", "ops", "kernels",
                               "peak_live_bytes")} for s in stats]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-3b-a800m",
                                  "mamba2-2.7b", "zamba2-7b",
                                  "whisper-large-v3", "llama-3.2-vision-90b"])
def test_each_family_counts_the_same_on_meta_and_cpu(arch):
    """FLOPs, bytes, ops, kernel work and the peak of live bytes; K1 and K2
    run their plain routes on the CPU at the reduced head width of 16,
    counted by their outputs, as on the card."""
    model = build_model(reduced_config(arch))
    assert model.cfg.resolved_head_dim == 16
    meta, cpu = _steps(model, "meta"), _steps(model, "cpu")
    assert meta == cpu
    assert all(s["peak_live_bytes"] > 0 for s in meta)
    update, prefill, decode = meta
    layers = model.cfg.num_layers
    if model.cfg.family in ("dense", "moe"):
        # remat: K1 in the forward and again in its recompute
        assert update["kernels"]["flash_attention"]["launches"] == 2 * layers
        assert prefill["kernels"]["flash_attention"]["launches"] == layers
        assert decode["kernels"]["decode_attention"]["launches"] == layers
    if model.cfg.family == "ssm":
        assert prefill["kernels"]["ssd"]["launches"] == layers
    assert all(s["flops"] > 0 and s["traffic_bytes"] > 0 for s in meta)


def test_reduced_cells_memory_beside_the_reference_xla():
    """qwen2-0.5b at ``reduced_config``: a prefill (B=2 S=64), an
    update_actor (B=4 S=64) and a decode step (B=2 T=64). The arguments
    agree with XLA's ``memory_analysis()`` (a decode's cache position is a
    host int in the port, an int32 there); the temporaries are printed
    beside XLA's, not held to them."""
    arch = "qwen2-0.5b"
    jm, tm = jbuild(jreduced(arch)), build_model(reduced_config(arch))
    for kind, b in (("prefill", 2), ("train", 4), ("decode", 2)):
        sh = ShapeSpec(kind, kind, 64, b)
        jbatch = {k: v.sds for k, v in jm.input_specs(sh).items()}
        if kind == "prefill":
            jargs = (jm.abstract_params(), jbatch)
            jfn, fn = jgrpo.make_prefill(jm), grpo.make_prefill(tm)
            args = (tm.abstract_params(), tm.abstract_batch(sh))
        elif kind == "train":
            jargs = (jts.abstract(jm), jbatch)
            jfn, fn = jgrpo.make_update_actor(jm), \
                grpo.make_update_actor(tm)
            args = (ts.abstract(tm), tm.abstract_batch(sh))
        else:
            jargs = (jm.abstract_params(), jm.abstract_cache(b, 64), jbatch)
            jfn, fn = jgrpo.make_decode(jm), grpo.make_decode(tm)
            args = (tm.abstract_params(), tm.abstract_cache(b, 64, pos=63),
                    tm.abstract_batch(sh))
        ma = jax.jit(jfn).lower(*jargs).compile().memory_analysis()
        out, stats = dryrun._counted(fn, args)
        mem = dryrun.memory_fields(args, out, stats["peak_live_bytes"])
        assert 0 <= ma.argument_size_in_bytes - mem["argument_bytes"] <= 4
        print(f"{arch} reduced {kind} B={b} 64: temp_bytes port "
              f"{mem['temp_bytes']} XLA {ma.temp_size_in_bytes} (ratio "
              f"{mem['temp_bytes'] / ma.temp_size_in_bytes:.4g}); outputs "
              f"{mem['output_bytes']} / {ma.output_size_in_bytes}, aliases "
              f"{mem['alias_bytes']} / {ma.alias_size_in_bytes}")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma2-27b"])
def test_reduced_forward_flops_match_the_reference_hlo_cost(arch):
    """The reference's XLA attention computes every query-key pair of its
    query chunks; K1's count keeps the causal ones (and gemma2's local
    layers only those in the window). Added back by closed form, the
    port's forward FLOPs equal the reference's within 1 %."""
    b, s = 2, 64
    jm = jbuild(jreduced(arch))
    compiled = jax.jit(lambda p, t: jm.forward(p, {"tokens": t})[0]).lower(
        jm.abstract_params(), jax.ShapeDtypeStruct((b, s), jnp.int32)
    ).compile()
    ref = jcost.analyze(compiled.as_text())["flops"]
    cfg = reduced_config(arch)
    tm = build_model(cfg)
    assert s % cfg.attn_q_chunk == 0          # no padded query rows
    with torch.no_grad():
        res = hlo_cost.analyze(lambda: tm.forward(
            tm.abstract_params(), {"tokens": _meta(b, s, dtype=torch.int32)}))
    k1 = res["kernels"]["flash_attention"]
    every_pair = cfg.num_layers * 4 * b * cfg.num_heads \
        * cfg.resolved_head_dim * s * s
    assert k1["launches"] == cfg.num_layers
    assert k1["flops"] < every_pair
    assert res["flops"] - k1["flops"] + every_pair == pytest.approx(
        ref, rel=0.01)


# -------------------------------------------------------------- dry run

DRY_CELLS = [("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "prefill_32k"),
             ("qwen2-0.5b", "decode_32k"), ("qwen2-0.5b", "long_500k"),
             ("paper-qwen3-30b-a3b", "train_4k"),
             ("mamba2-2.7b", "long_500k"), ("arctic-480b", "decode_32k")]


def _jax_outputs(arch, shape_name):
    """{key: (shape, dtype)} of the reference's step by ``jax.eval_shape``
    (its int32 ``pos`` leaf left out)."""
    jm = jbuild(jget_config(arch))
    shape = SHAPES[shape_name]
    batch = {k: v.sds for k, v in jm.input_specs(shape).items()}
    if shape.kind == "prefill":
        out = jax.eval_shape(jgrpo.make_prefill(jm), jm.abstract_params(),
                             batch)
    else:
        out = jax.eval_shape(jgrpo.make_decode(jm), jm.abstract_params(),
                             jm.abstract_cache(shape.global_batch,
                                               shape.seq_len), batch)
    flat = jflat({"0": out[0], "1": out[1]},
                 is_leaf=lambda x: hasattr(x, "shape"))
    return {k: [list(v.shape), f"torch.{jnp.dtype(v.dtype)}"]
            for k, v in flat.items() if k != "1/pos"}


@pytest.mark.parametrize("arch,shape_name", DRY_CELLS)
def test_dryrun_cell_at_full_width(arch, shape_name):
    res = dryrun.run_cell(arch, shape_name, verbose=False)
    json.dumps(res)
    if arch == "qwen2-0.5b" and shape_name == "long_500k":
        assert res["status"] == "SKIP"
        return
    assert res["status"] == "OK" and res["mesh"] == "h100x1"
    cfg = get_config(arch)
    assert res["params"] == jbuild(jget_config(arch)).param_count()
    r = res["roofline"]
    assert r["flops"] > 0 and r["traffic_bytes"] > 0
    assert r["compute_term_s"] == r["flops"] / mesh.HW["peak_flops_bf16"]
    assert r["memory_term_s"] == r["traffic_bytes"] / mesh.HW["hbm_bw"]
    assert r["collective_bytes"] == 0
    assert 0 < r["useful_flops_ratio"] < 1.5
    m = res["memory"]
    assert m["per_device_bytes"] == m["argument_bytes"] + m["temp_bytes"] \
        + m["output_bytes"] - m["alias_bytes"]
    assert m["argument_bytes"] == res["argument_bytes_total"]
    assert res["fits_one_card"] == (m["per_device_bytes"] <= 80e9)
    one_device = types.SimpleNamespace(axis_names=(), shape={})
    accum = jdryrun.default_grad_accum(arch, SHAPES[shape_name], one_device)
    assert m["microbatch"] == {"grad_accum": accum,
                               "batch": SHAPES[shape_name].global_batch
                               // accum}
    if SHAPES[shape_name].kind == "train":     # the in-place train state
        assert m["alias_bytes"] > 0 and m["temp_bytes"] > 0
    k = {name: v["launches"] for name, v in res["kernels"].items()}
    kind = SHAPES[shape_name].kind
    if cfg.family in ("dense", "moe"):
        want = {"train": 2 * cfg.num_layers, "prefill": cfg.num_layers,
                "decode": 0}[kind]
        assert k["flash_attention"] == want
        assert k["decode_attention"] == (cfg.num_layers if kind == "decode"
                                         else 0)
    if (arch, shape_name) in (("qwen2-0.5b", "prefill_32k"),
                              ("mamba2-2.7b", "long_500k")):
        outs = {k: v for k, v in res["outputs"].items() if k != "1/pos"}
        assert outs == _jax_outputs(arch, shape_name)


def test_dryrun_main_writes_cells_and_refuses_unported_meshes(tmp_path):
    """``main`` writes a one-card cell (cached on a second call) and, with
    ``--both-meshes``, ``--multi-pod`` and ``--rules``, the cells of the
    production meshes under ``<out>/h100_16x16/`` and
    ``<out>/h100_2x16x16/``, counted on ``meta``; no mesh is refused."""
    out = str(tmp_path)
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--out",
                 out])
    path = tmp_path / "h100x1" / "qwen2-0.5b__decode_32k.json"
    cell = json.loads(path.read_text())
    assert cell["status"] == "OK" and cell["argument_bytes"]["cache"] == \
        2 * 24 * 128 * 32768 * 2 * 64 * 2
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--out",
                 out])                            # cached: not recounted
    assert json.loads(path.read_text()) == cell
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--out",
                 out, "--both-meshes"])
    for name, chips in (("h100_16x16", 256), ("h100_2x16x16", 512)):
        got = json.loads((tmp_path / name / "qwen2-0.5b__decode_32k.json")
                         .read_text())
        assert got["status"] == "OK" and got["n_chips"] == chips
        assert got["rules"] == "tp" and got["mesh"] == name
        assert "meta" in got["counted"]
        assert set(got["collectives"]) == {"bytes_by_kind", "counts",
                                           "total_bytes"}
        assert got["collectives"]["bytes_by_kind"]["all-reduce"] > 0
        assert set(got["roofline"]) >= {
            "hlo_flops_per_device", "hlo_bytes_per_device",
            "collective_bytes_per_device", "compute_term_s",
            "memory_term_s", "collective_term_s", "dominant",
            "model_flops_total", "hlo_flops_total", "useful_flops_ratio"}
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--out",
                 out, "--rules", "fsdp_tp"])
    got = json.loads((tmp_path / "h100_16x16" / "qwen2-0.5b__decode_32k.json")
                     .read_text())
    assert got["rules"] == "fsdp_tp"
    m = mesh.make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.size == 256
    assert mesh.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    assert 5 not in shd.PARTS and set(shd.PARTS) == {6}
    assert (mesh.HW["peak_flops_bf16"], mesh.HW["hbm_bw"],
            mesh.HW["hbm_bytes"], mesh.HW["nvlink_bw"]) == (
        989e12, 3.35e12, 80e9, 900e9)
    assert mesh.bound(3.35e9, 1.0) == (pytest.approx(1.0), "bytes")


# ------------------------------------------------ the production meshes

class _Mesh:
    """A shape-only mesh for the reference's resolve."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


_MESHES = {"h100_16x16": {"data": 16, "model": 16},
           "h100_2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _ref_local_bytes(specs, axes, dtypes, mesh, rules, moments=False):
    """The sum, over the reference's specs of a tree, of each leaf's bytes
    over its split (``moments``: in ZeRO-2's layout, f32)."""
    from repro.models import sharding as jshd
    from repro.train import optimizer as jopt
    total = 0
    for k, ax in axes.items():
        shape = specs[k]
        spec = jshd.resolve(ax, mesh, rules, shape=shape)
        if moments:
            spec = jopt.zero_moment_spec(spec, shape, mesh)
        parts = 1
        for e in tuple(spec):
            for a in ((e,) if isinstance(e, str) else (e or ())):
                parts *= mesh.shape[a]
        total += int(np.prod(shape)) * dtypes[k] // parts
    return total


def _ref_argument_bytes(arch, shape_name, mesh_name, rules_name):
    from repro.models import common as jcommon
    from repro.models import sharding as jshd
    jm = jbuild(jget_config(arch))
    shape = SHAPES[shape_name]
    mesh_s = _Mesh(_MESHES[mesh_name])
    rules = jshd.named_rules(rules_name)
    specs = jm.param_specs()
    axes = jcommon.canonical_flat(jcommon.logical_axes(specs),
                                  is_leaf=lambda x: isinstance(x, tuple))
    shapes = {k: tuple(v.shape) for k, v in jflat(
        jm.abstract_params(), is_leaf=lambda x: hasattr(x, "shape")).items()}
    widths = {k: jnp.dtype(v.dtype).itemsize for k, v in jflat(
        jm.abstract_params(), is_leaf=lambda x: hasattr(x, "shape")).items()}
    total = _ref_local_bytes(shapes, axes, widths, mesh_s, rules)
    if shape.kind == "train" and arch not in jdryrun.HOST_OPTIM:
        f32 = {k: 4 for k in widths}
        total += 2 * _ref_local_bytes(shapes, axes, f32, mesh_s, rules,
                                      moments=True) + 2 * 4
    if shape.kind == "decode":
        cspecs = jm.cache_specs(shape.global_batch, shape.seq_len)
        caxes = jcommon.canonical_flat(jcommon.logical_axes(cspecs),
                                       is_leaf=lambda x: isinstance(x, tuple))
        cabs = jflat(jcommon.abstract_params(cspecs),
                     is_leaf=lambda x: hasattr(x, "shape"))
        # the reference's int32 ``pos`` leaf is a host int in the port
        caxes = {k: v for k, v in caxes.items() if k != "pos"}
        total += _ref_local_bytes(
            {k: tuple(v.shape) for k, v in cabs.items()}, caxes,
            {k: jnp.dtype(v.dtype).itemsize for k, v in cabs.items()},
            mesh_s, rules)
    for v in jm.input_specs(shape).values():
        total += _ref_local_bytes({0: tuple(v.sds.shape)}, {0: v.axes},
                                  {0: jnp.dtype(v.sds.dtype).itemsize},
                                  mesh_s, rules)
    return total


def _proj_flops(cfg, tokens, q=True, kv=True):
    """A layer's forward attention projections over ``tokens``: Q and O
    (``q``), K and V (``kv``)."""
    hd, d = cfg.resolved_head_dim, cfg.d_model
    out = 0
    if q:
        out += 2 * 2 * tokens * d * cfg.num_heads * hd
    if kv:
        out += 2 * 2 * tokens * d * cfg.num_kv_heads * hd
    return out


def _replicated_flops(arch, shape_name, one):
    """The products a production mesh's rules replicate, which its
    devices count beside the one card's (``one``: its h100x1 cell), as
    the mesh total's excess: 15 more copies where a 16-way model axis
    does not split them.

    - qwen2-0.5b x train_4k (14 heads, 2 KV heads): all of attention. A
      layer's projections run four times (forward, ``remat``'s rerun and
      two products in the backward); K1 as counted; the backward's XLA
      attention over every query-key pair, 14 B H S^2 D a layer (its two
      products, the scores again in its query blocks' checkpointed rerun
      and four products in their backward).
    - paper-qwen3-30b-a3b x train_4k (4 KV heads): the K/V projections.
    - arctic-480b x decode_32k (56 heads, 8 KV heads): the Q, K and V
      projections of one token a sequence. The cache splits over
      head_dim (``cache_hd``): the head-dim-parallel decode splits the
      scores and the output projection over the model axis.
    - zamba2-7b x long_500k: batch 1 under ``long`` is replicated over
      the 16 data rows but for K2, whose keys split over them: the mesh
      runs 16 copies less 15 of K2's work."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    b, s, n = shape.global_batch, shape.seq_len, cfg.num_layers
    k1 = one["kernels"]["flash_attention"]["flops"]
    k2 = one["kernels"]["decode_attention"]["flops"]
    assert k1 or k2
    if arch == "qwen2-0.5b":
        attn = 4 * n * _proj_flops(cfg, b * s) + k1 \
            + n * 14 * b * cfg.num_heads * s * s * cfg.resolved_head_dim
        return 15 * attn
    if arch == "paper-qwen3-30b-a3b":
        return 15 * 4 * n * _proj_flops(cfg, b * s, q=False)
    if arch == "arctic-480b":
        hd, d = cfg.resolved_head_dim, cfg.d_model
        return 15 * n * (2 * b * d * cfg.num_heads * hd
                         + _proj_flops(cfg, b, q=False))
    if arch == "zamba2-7b":
        return 15 * one["roofline"]["flops"] - 15 * k2
    raise KeyError(arch)


MESH_CELLS = [("qwen2-0.5b", "train_4k", "h100_16x16", "tp"),
              ("paper-qwen3-30b-a3b", "train_4k", "h100_16x16", "fsdp_tp"),
              ("zamba2-7b", "long_500k", "h100_16x16", "long"),
              ("arctic-480b", "decode_32k", "h100_2x16x16", "fsdp_tp")]
_ONE_CARD = {}


def _one_card(arch, shape_name):
    if (arch, shape_name) not in _ONE_CARD:
        _ONE_CARD[arch, shape_name] = dryrun.run_cell(arch, shape_name,
                                                      verbose=False)
    return _ONE_CARD[arch, shape_name]


@pytest.mark.parametrize("arch,shape_name,mesh_name,rules", MESH_CELLS)
def test_dryrun_cell_on_a_production_mesh(arch, shape_name, mesh_name,
                                          rules):
    """Per device: the argument bytes are the sum, over the reference's
    specs, of each leaf's bytes over its split; the mesh's FLOPs are the
    one card's plus the products the rules replicate (closed form,
    1 %)."""
    res = dryrun.run_mesh_cell(arch, shape_name, mesh_name, verbose=False)
    json.dumps(res)
    assert res["status"] == "OK" and res["rules"] == rules
    assert res["n_chips"] == {"h100_16x16": 256, "h100_2x16x16": 512}[
        mesh_name]
    assert res["host_optim"] == (arch in dryrun.HOST_OPTIM
                                 and SHAPES[shape_name].kind == "train")
    assert res["memory"]["argument_bytes"] == _ref_argument_bytes(
        arch, shape_name, mesh_name, rules)
    one = _one_card(arch, shape_name)
    r = res["roofline"]
    assert r["hlo_flops_total"] == pytest.approx(
        r["hlo_flops_per_device"] * res["n_chips"])
    assert r["hlo_flops_total"] == pytest.approx(
        one["roofline"]["flops"] + _replicated_flops(arch, shape_name, one),
        rel=0.01)
    assert r["collective_bytes_per_device"] > 0
    assert r["collective_term_s"] == pytest.approx(
        r["collective_bytes_per_device"] / mesh.HW["nvlink_bw"])
    assert r["dominant"] in ("compute", "memory", "collective")
    one_mesh = _Mesh(_MESHES[mesh_name])
    assert res["grad_accum"] == jdryrun.default_grad_accum(
        arch, SHAPES[shape_name], one_mesh)
    assert dryrun.default_rules_name(arch, SHAPES[shape_name]) == \
        jdryrun.default_rules_name(arch, SHAPES[shape_name])


_CHILD = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.launch import hlo_cost
from repro.models import sharding as shd
from repro.models.layers import Ctx
from repro.models.registry import build_model
cfg = get_config("qwen2-0.5b").replace(**json.loads(sys.argv[1]))
jm = build_model(cfg)
mesh = jax.make_mesh((2, 2), ("data", "model"))
rules = shd.named_rules("tp")
ctx = Ctx(mesh, rules)
params = jm.abstract_params()
pshd = shd.tree_shardings(jm.logical_axes(), mesh, rules, params)
tshd = NamedSharding(mesh, shd.resolve(("batch", "seq"), mesh, rules, (4, 64)))
fn = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}, ctx)[0],
             in_shardings=(pshd, tshd))
with mesh:
    compiled = fn.lower(params, jax.ShapeDtypeStruct((4, 64), jnp.int32)
                        ).compile()
print(json.dumps(hlo_cost.analyze(compiled.as_text())))
"""


def test_reduced_forward_per_device_flops_match_the_reference_on_4_devices():
    """The reference compiles a reduced qwen2 forward (B = 4, S = 64) on a
    (2, 2) mesh of four forced host devices in a child process; its
    per-device HLO FLOPs equal the port's per-device count on a (2, 2)
    ``meta`` mesh within 1 %, once K1's causal half is put back (as
    :func:`test_reduced_forward_flops_match_the_reference_hlo_cost`).
    Both sides' collective bytes are printed, not held: GSPMD chooses its
    own collectives."""
    import dataclasses as dc
    import subprocess
    import sys
    cfg = reduced_config("qwen2-0.5b")
    full = get_config("qwen2-0.5b")
    overrides = {f.name: getattr(cfg, f.name) for f in dc.fields(cfg)
                 if getattr(cfg, f.name) != getattr(full, f.name)}
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _CHILD,
                           json.dumps(overrides)], env=env, timeout=300,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.layers import make_ctx
    model = build_model(cfg)
    m = Mesh(np.full((2, 2), torch.device("meta"), dtype=object),
             ("data", "model"))
    ctx = make_ctx(m, "tp")
    params = shd.device_put(model.abstract_params(), shd.tree_shardings(
        model.logical_axes(), m, ctx.rules, model.param_specs()))
    b, s = 4, 64
    with torch.no_grad():
        got = hlo_cost.analyze(model.forward, params,
                               {"tokens": _meta(b, s, dtype=torch.int32)},
                               ctx=ctx)
    every_pair = cfg.num_layers * 4 * b * cfg.num_heads \
        * cfg.resolved_head_dim * s * s
    k1 = got["kernels"]["flash_attention"]["flops"]
    per_device = (got["flops"] - k1 + every_pair) / 4
    assert per_device == pytest.approx(ref["flops"], rel=0.01)
    print(f"reduced qwen2 forward on (2, 2): collective bytes a device: "
          f"port {got['collective_bytes'] / 4:.0f} "
          f"{ {k: v['bytes'] / 4 for k, v in got['collectives'].items()} }, "
          f"reference {ref['collective_bytes']:.0f}")
