"""Dry run: build every (architecture x input shape) cell at full width and
depth and count its step's work, without a card.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell for a TPU pod and reads the roofline terms off the compiled HLO. Here
each cell's step runs once on ``meta`` tensors (shapes and dtypes, no
storage, no arithmetic) under ``launch/hlo_cost.Counter``, which counts
the dispatched ops' FLOPs and bytes and each kernel's launches and work.
So the dry run needs no card, and any model of the repository is built at
full width and depth, whatever its size; ``chip_smoke.py`` phase 29 holds
its counts against the same steps executed on the card.

The step of a cell is the reference's (``repro/launch/dryrun.py:151-238``):
``update_actor`` for a train cell (``compute_grads`` for the
:data:`HOST_OPTIM` models, whose optimizer runs on the host), the prefill
for a prefill cell, one decode step against a cache of ``seq_len`` slots,
at its last slot, for a decode cell. A train cell counts its FLOPs and
bytes over its batch in one microbatch (``grad_accum`` 1): the split
changes no matmul's FLOPs, and one microbatch reads each weight once.

Per cell it records the reference's fields where one card gives them:
``params``, ``active_params``, the argument bytes (state, inputs, cache),
``flops``, ``traffic_bytes``, ``compute_term_s`` and ``memory_term_s`` at
the card's datasheet peaks (``launch/mesh.HW``), the ``dominant`` term,
``model_flops_total`` (2 or 6 x active params x tokens),
``useful_flops_ratio``, and ``memory``: the reference's
``memory_analysis()`` fields ``argument_bytes``, ``temp_bytes``,
``output_bytes`` and ``alias_bytes`` (outputs that are arguments' storage,
as the in-place train state), from ``hlo_cost``'s peak of live bytes:
``temp_bytes`` is that peak less the outputs the step makes, so
``per_device_bytes`` = arguments + temporaries + outputs - aliases, the
reference's per-device sum, is the arguments plus the peak.
``fits_one_card`` holds it to the card's 80 GB. A train cell's
temporaries are those of one microbatch of the reference's
``default_grad_accum`` (its microbatches keep a TPU's saved activations
under 6 GB; its compiled step peaks at one), counted in a second run of
the step on that microbatch, plus the f32 gradient accumulator
(``compute_grads``) where there is more than one; ``memory["microbatch"]``
says which. The mesh is ``h100x1``; one card has no collectives.

``--both-meshes`` (and ``--multi-pod``, ``--rules``) count the cells of
the reference's production meshes as H100s, ``h100_16x16`` (``data`` x
``model``) and ``h100_2x16x16`` (``pod`` x ``data`` x ``model``), on
``meta`` devices (:func:`run_mesh_cell`): the rules of the reference's
:func:`default_rules_name`, its :func:`default_grad_accum` over the
batch's data shards, the train state in ZeRO-2's layout, each device's
FLOPs, bytes, ops, kernel work, memory and collective bytes by kind, and
the compute, memory and collective terms at the datasheet rates
(``mesh.HW``, the collective term over NVLink's). Nothing there is
measured.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--force]

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Artifacts: ``<out>/<mesh>/<arch>__<shape>.json`` (``--out``, default
``build/repro_torch_dryrun/``; ``<mesh>`` ``h100x1``, ``h100_16x16`` or
``h100_2x16x16``); a cell already written is skipped unless ``--force``
(or ``--rules``).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
import math
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import SHAPES, ShapeSpec, get_config, list_configs
from repro_torch.configs import shape_applicable
from repro_torch.launch import hlo_cost
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.models import common
from repro_torch.models import sharding as shd
from repro_torch.models.layers import make_ctx
from repro_torch.models.registry import build_model
from repro_torch.rl import grpo
from repro_torch.train import optimizer as opt
from repro_torch.train import train_state as ts

MESH = "h100x1"
# the production meshes by name: multi-pod or not
PROD_MESHES = {"h100_16x16": False, "h100_2x16x16": True}
OUT_DIR = "build/repro_torch_dryrun"

# the reference's ZeRO-offload models: their train cells lower the gradient
# step and the optimizer runs on the host (StateManager, paper §4.5.4)
HOST_OPTIM = {"arctic-480b", "paper-qwen3-235b-a22b"}


def tree_bytes(tree) -> int:
    """Bytes of the tensors in a nested dict / tuple tree (a ``Sharded``
    leaf's locals)."""
    if isinstance(tree, shd.Sharded):
        return sum(tree_bytes(t) for t in tree.locals)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def tree_shapes(tree, prefix: str = "") -> Dict[str, list]:
    """{'/'-joined path: [shape, dtype]} of the tensors in a tree (the
    canonical keys of ``models/common.py``)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: [list(tree.shape), str(tree.dtype)]}
    items = tree._asdict().items() if hasattr(tree, "_asdict") else \
        tree.items() if isinstance(tree, dict) else \
        enumerate(tree) if isinstance(tree, (list, tuple)) else ()
    out: Dict[str, list] = {}
    for k, v in items:
        out.update(tree_shapes(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def default_rules_name(arch: str, shape: ShapeSpec) -> str:
    """The reference's rules per cell (``repro/launch/dryrun.py:48-56``):
    ``long`` for the batch-1 500k decode, ``fsdp_tp`` for a model of more
    than 8 GB of bf16 parameters or with experts, else ``tp``."""
    if shape.name == "long_500k":
        return "long"
    cfg = get_config(arch)
    big = build_model(cfg).param_count() * 2 > 8e9
    return "fsdp_tp" if (big or cfg.num_experts) else "tp"


def pad_heads_overrides(arch: str, mesh_model: int = 16) -> dict:
    """The reference's variant (``repro/launch/dryrun.py:241-250``): query
    heads padded up to a multiple of the model axis, so attention splits
    over it (the padded rows' work is waste)."""
    h = get_config(arch).num_heads
    padded = -(-h // mesh_model) * mesh_model
    return {"num_heads": padded} if padded != h else {}


def default_grad_accum(arch: str, shape: ShapeSpec, mesh=None) -> int:
    """The reference's microbatch count (``repro/launch/dryrun.py:63-77``):
    over the batch's data shards (``pod`` x ``data`` of ``mesh``; one card
    without), doubled while a microbatch's saved activations, 2.5 bf16
    copies of the residual stream a layer, pass 6 GB."""
    if shape.kind != "train":
        return 1
    cfg = get_config(arch)
    shards = 1
    for ax in ("pod", "data"):
        if mesh is not None and ax in mesh.axis_names:
            shards *= mesh.shape[ax]
    b_local = max(1, shape.global_batch // shards)
    layers = cfg.num_layers + cfg.encoder_layers
    carry_bytes = layers * b_local * shape.seq_len * cfg.d_model * 2 * 2.5
    accum = 1
    while carry_bytes / accum > 6e9 and accum < b_local:
        accum *= 2
    return accum


def _storages(tree) -> Dict[int, int]:
    """{id: bytes} of the distinct storages of the tensors in a tree."""
    out: Dict[int, int] = {}

    def walk(x):
        if isinstance(x, shd.Sharded):
            for t in x.locals:
                walk(t)
        elif isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            out[id(st)] = st.nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return out


def memory_fields(args, out, peak_live: int, extra_temp: int = 0,
                  arguments=None):
    """The reference's ``memory_analysis()`` fields of a step run on
    ``args`` that returned ``out`` at ``peak_live`` bytes (``hlo_cost``):
    the outputs that are storages of the arguments are aliases, the rest
    were made by the step and lie inside its peak. ``arguments`` (default
    ``args``) gives the argument bytes: a train cell's whole batch where
    ``args`` holds one microbatch."""
    held, made = _storages(args), _storages(out)
    alias = sum(n for k, n in made.items() if k in held)
    output = sum(made.values())
    temp = max(peak_live - (output - alias), 0) + extra_temp
    argument = sum(_storages(args if arguments is None
                             else arguments).values())
    return {"argument_bytes": argument, "temp_bytes": temp,
            "output_bytes": output, "alias_bytes": alias,
            "per_device_bytes": argument + temp + output - alias}


def _counted(fn, args):
    """``fn(*args)`` under ``hlo_cost.Counter``: (its output, stats)."""
    # a full-width step dispatches ~10^5 ops, each making short-lived Python
    # objects: frozen, the heap that exists before it is not walked again
    # by every collection (a quarter of the time in a test process)
    gc.freeze()
    try:
        with hlo_cost.Counter() as counter:
            out = fn(*args)
    finally:
        gc.unfreeze()
    return out, counter.stats()


def build_cell(arch: str, shape: ShapeSpec):
    """(step, its meta arguments, {argument group: bytes}) of a cell."""
    model = build_model(get_config(arch))
    batch = model.abstract_batch(shape)
    if shape.kind == "train":
        if arch in HOST_OPTIM:
            def grad_step(params, batch):
                return grpo.compute_grads(params, model, batch,
                                          grpo.GRPOConfig())

            params = model.abstract_params()
            return grad_step, (params, batch), {
                "params": tree_bytes(params), "inputs": tree_bytes(batch)}
        state = ts.abstract(model)
        step = grpo.make_update_actor(model)
        return step, (state, batch), {
            "state": tree_bytes(state), "inputs": tree_bytes(batch)}
    params = model.abstract_params()
    if shape.kind == "prefill":
        return grpo.make_prefill(model), (params, batch), {
            "params": tree_bytes(params), "inputs": tree_bytes(batch)}
    cache = model.abstract_cache(shape.global_batch, shape.seq_len,
                                 pos=shape.seq_len - 1)
    return grpo.make_decode(model), (params, cache, batch), {
        "params": tree_bytes(params), "cache": tree_bytes(cache),
        "inputs": tree_bytes(batch)}


def run_cell(arch: str, shape_name: str,
             verbose: bool = True) -> Dict[str, Any]:
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    ok, reason = shape_applicable(cfg, shape)
    result: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                              "mesh": MESH, "kind": shape.kind}
    if not ok:
        result.update(status="SKIP", reason=reason)
        return result
    result["grad_accum"] = 1
    result["host_optim"] = arch in HOST_OPTIM and shape.kind == "train"
    accum = default_grad_accum(arch, shape)
    t0 = time.time()
    fn, args, arg_bytes = build_cell(arch, shape)
    t_build = time.time() - t0
    t0 = time.time()
    out, hc = _counted(fn, args)
    model = build_model(cfg)
    n_params = model.param_count()
    if accum == 1:
        mem = memory_fields(args, out, hc["peak_live_bytes"])
    else:
        # the temporaries of one microbatch, and the f32 accumulator of
        # its gradients
        micro = dataclasses.replace(shape,
                                    global_batch=shape.global_batch // accum)
        m_fn, m_args, _ = build_cell(arch, micro)
        m_out, m_hc = _counted(m_fn, m_args)
        mem = memory_fields(m_args, m_out, m_hc["peak_live_bytes"],
                            extra_temp=4 * n_params, arguments=args)
    mem["microbatch"] = {"grad_accum": accum,
                         "batch": shape.global_batch // accum}
    t_count = time.time() - t0
    n_active = model.active_param_count()
    flops, nbytes = hc["flops"], hc["traffic_bytes"]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = {"train": 6, "prefill": 2, "decode": 2}[shape.kind]
    model_flops = mult * n_active * tokens
    compute_s = flops / HW["peak_flops_bf16"]
    memory_s = nbytes / HW["hbm_bw"]
    total_args = sum(arg_bytes.values())
    result.update({
        "status": "OK",
        "n_chips": 1,
        "device": HW["name"],
        "params": n_params,
        "active_params": n_active,
        "build_s": t_build,
        "count_s": t_count,
        "argument_bytes": arg_bytes,
        "argument_bytes_total": total_args,
        "memory": mem,
        "fits_one_card": mem["per_device_bytes"] <= HW["hbm_bytes"],
        "ops": hc["ops"],
        "kernels": hc["kernels"],
        "roofline": {
            "flops": flops,
            "traffic_bytes": nbytes,
            "collective_bytes": 0,
            "compute_term_s": compute_s,
            "memory_term_s": memory_s,
            "collective_term_s": 0.0,
            "dominant": "compute" if compute_s >= memory_s else "memory",
            "model_flops_total": model_flops,
            "useful_flops_ratio": model_flops / flops if flops else 0.0,
        },
        "outputs": tree_shapes(out),
    })
    if verbose:
        r = result["roofline"]
        print(f"[{MESH}] {arch} x {shape_name}: count {t_count:.1f}s | "
              f"args {total_args / 1e9:.2f} GB, temp "
              f"{mem['temp_bytes'] / 1e9:.2f} GB (microbatch "
              f"{mem['microbatch']['batch']}), per device "
              f"{mem['per_device_bytes'] / 1e9:.2f} GB "
              f"({'fits' if result['fits_one_card'] else 'exceeds'} one "
              f"card) | flops {flops:.3e} | bytes {nbytes:.3e} | "
              f"dominant={r['dominant']} | "
              f"useful={100 * r['useful_flops_ratio']:.1f}%")
    return result


# ------------------------------------------------- the production meshes

def depth_configs(cfg):
    """The config at one and at two repeating units of its layers, and the
    units at full depth: ``(cfg_1, cfg_2, units)``, or None where the
    layers do not repeat in units (then the cell is counted whole). A unit
    is a layer (gemma2: a local/global pair), a hybrid's group of Mamba2
    blocks and its shared-block application (its trailing blocks kept at
    both depths), an encoder and a decoder layer, a vlm's self layers and
    cross layer."""
    fam, n = cfg.family, cfg.num_layers
    if fam in ("dense", "moe", "ssm"):
        unit = cfg.local_global_period or 1
        mk = lambda u: cfg.replace(num_layers=u * unit)      # noqa: E731
        units = n // unit
    elif fam == "hybrid":
        q, rem = cfg.attn_period, n % cfg.attn_period
        mk = lambda u: cfg.replace(num_layers=u * q + rem)   # noqa: E731
        units = n // q
    elif fam == "audio" and cfg.encoder_layers == n:
        mk = lambda u: cfg.replace(num_layers=u,             # noqa: E731
                                   encoder_layers=u)
        units = n
    elif fam == "vlm":
        p = cfg.cross_attn_period
        mk = lambda u: cfg.replace(num_layers=u * p)         # noqa: E731
        units = n // p
    else:
        return None
    return (mk(1), mk(2), units) if units > 2 else None


def _extrapolate(one, two, units: int):
    """``one + (units - 1) (two - one)`` through nested dicts of numbers:
    the count of ``units`` repeating units from counts at one and two (the
    reference weights its scan body by its trip count the same way,
    ``repro/launch/hlo_cost.py``)."""
    if isinstance(one, dict):
        return {k: _extrapolate(one[k], two[k], units) for k in one}
    if isinstance(one, tuple):
        return tuple(_extrapolate(a, b, units) for a, b in zip(one, two))
    return one + (units - 1) * (two - one)


def mesh_cell_args(model, shape: ShapeSpec, mesh, rules_name: str,
                   host_optim: bool):
    """(step, its arguments, ctx) of a cell on a production mesh, the
    ``Sharded`` arguments holding the first data row's locals
    (``layers.Ctx.rows``): the reference's steps and layouts
    (``repro/launch/dryrun.py:151-238``), the train state in ZeRO-2's
    layout (``train_state.shardings(zero=True)``)."""
    ctx = make_ctx(mesh, rules_name, rows=1)
    n = ctx.size
    batch = model.abstract_batch(shape)
    pshd = shd.tree_shardings(model.logical_axes(), mesh, ctx.rules,
                              model.param_specs())
    if shape.kind == "train":
        if host_optim:
            def grad_step(params, batch):
                return grpo.compute_grads(params, model, batch,
                                          grpo.GRPOConfig(), ctx=ctx)

            return grad_step, (shd.device_put(model.abstract_params(),
                                              pshd, n), batch), ctx
        shs = ts.shardings(model, mesh, ctx.rules, zero=True)
        st = ts.abstract(model)
        state = ts.TrainState(
            shd.device_put(st.params, shs.params, n),
            opt.AdamWState(*(shd.device_put(getattr(st.opt_state, f),
                                            getattr(shs.opt_state, f), n)
                             for f in ("step", "mu", "nu"))),
            shd.device_put(st.step, shs.step, n))
        update = grpo.make_update_actor(model)
        return (lambda s, b: update(s, b, ctx=ctx)), (state, batch), ctx
    params = shd.device_put(model.abstract_params(), pshd, n)
    if shape.kind == "prefill":
        prefill = grpo.make_prefill(model)
        return (lambda p, b: prefill(p, b, ctx=ctx)), (params, batch), ctx
    specs = model.cache_specs(shape.global_batch, shape.seq_len)
    cache = dict(shd.device_put(
        common.abstract_params(specs), shd.tree_shardings(
            common.logical_axes(specs), mesh, ctx.rules, specs), n),
        pos=shape.seq_len - 1)
    decode = grpo.make_decode(model)
    return (lambda p, c, b: decode(p, c, b, ctx=ctx)), (params, cache,
                                                        batch), ctx


def per_device_counts(stats, n: int):
    """A count of ``n`` positions as per device: every number over ``n``
    (the mean of the devices, whose programs are alike but for the
    first's loss and logits)."""
    if isinstance(stats, dict):
        return {k: per_device_counts(v, n) for k, v in stats.items()}
    return stats / n


def _row_count(cfg, shape: ShapeSpec, mesh, rules_name, host_optim):
    """One data row's counts of a cell's step (and its memory fields), at
    the config's depth."""
    model = build_model(cfg)
    fn, args, ctx = mesh_cell_args(model, shape, mesh, rules_name,
                                   host_optim)
    out, hc = _counted(fn, args)
    mem = memory_fields(args, out, hc["peak_live_bytes"])
    return {k: hc[k] for k in ("flops", "traffic_bytes", "ops", "kernels",
                               "collectives", "peak_live_bytes")}, mem


def _zero_elems(model, mesh, rules) -> int:
    """A device's elements of the parameters in ZeRO-2's layout of the
    moments (and gradients)."""
    mu = ts.shardings(model, mesh, rules, zero=True).opt_state.mu
    specs = common.canonical_flat(model.param_specs())
    return sum(math.prod(specs[k].shape) // math.prod(sh.parts(
        len(specs[k].shape))) for k, sh in common.canonical_flat(mu).items())


def _input_bytes(model, shape: ShapeSpec, mesh, rules) -> int:
    """A device's bytes of the step's inputs, each split by its logical
    axes (the batch over ``pod`` x ``data``)."""
    total = 0
    for sp in model.input_specs(shape).values():
        sh = shd.NamedSharding(mesh, shd.resolve(sp.axes, mesh, rules,
                                                 shape=sp.shape))
        local = math.prod(n // p for n, p in zip(sp.shape,
                                                  sh.parts(len(sp.shape))))
        total += local * torch.empty((), dtype=sp.dtype).element_size()
    return total


def run_mesh_cell(arch: str, shape_name: str, mesh_name: str,
                  rules_name: Optional[str] = None,
                  verbose: bool = True) -> Dict[str, Any]:
    """A cell on a production mesh, counted per device on ``meta``.

    One data row (16 devices, ``Ctx.rows``) runs the step on its block of
    the batch: every row's program is the same (equal blocks), so the
    mesh's counts are the row's times its rows, and a device's the row's
    mean (``tests/test_torch_dp.py`` holds the row against every device
    of a (2, 2) mesh, exactly). The collectives' bytes are those each
    device receives, by kind. A model whose layers repeat is counted at
    one and two units of them and extrapolated in their number
    (:func:`depth_configs`), as the reference's count weights its scan
    body by its trip count; the peak of live bytes, which is no sum, is
    extrapolated the same way, as a line in the depth. Nothing is
    measured: every term is a count on ``meta`` over the card's datasheet
    rates (``mesh.HW``)."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    ok, reason = shape_applicable(cfg, shape)
    result: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                              "mesh": mesh_name, "kind": shape.kind}
    if not ok:
        result.update(status="SKIP", reason=reason)
        return result
    mesh = make_production_mesh(multi_pod=PROD_MESHES[mesh_name])
    rules_name = rules_name or default_rules_name(arch, shape)
    rules = shd.named_rules(rules_name)
    accum = default_grad_accum(arch, shape, mesh)
    host_optim = arch in HOST_OPTIM and shape.kind == "train"
    n_chips, m = mesh.size, mesh.shape["model"]
    result.update(rules=rules_name, grad_accum=accum, host_optim=host_optim,
                  n_chips=n_chips)
    t0 = time.time()
    depths = depth_configs(cfg)
    shapes = [shape]
    if accum > 1:
        shapes.append(dataclasses.replace(
            shape, global_batch=shape.global_batch // accum))
    counts = []
    for sh in shapes:
        if depths is None:
            counts.append(_row_count(cfg, sh, mesh, rules_name, host_optim))
            continue
        c1, c2, units = depths
        one = _row_count(c1, sh, mesh, rules_name, host_optim)
        two = _row_count(c2, sh, mesh, rules_name, host_optim)
        counts.append(_extrapolate(one, two, units))
    t_count = time.time() - t0
    hc = per_device_counts(counts[0][0], m)
    mem_row = counts[-1][1]
    model = build_model(cfg)
    # the arguments at full depth, a device's blocks
    fn, args, ctx = mesh_cell_args(model, shape, mesh, rules_name,
                                   host_optim)
    held = sum(_storages(args[:-1]).values()) // m
    arg_bytes = held + _input_bytes(model, shape, mesh, rules)
    temp = max(mem_row["temp_bytes"], 0) // m
    if accum > 1:
        # the f32 accumulator of the gradients (``compute_grads``), a
        # device's ZeRO blocks of them
        temp += 4 * _zero_elems(model, mesh, rules)
    mem = {"argument_bytes": arg_bytes, "temp_bytes": temp,
           "output_bytes": mem_row["output_bytes"] // m,
           "alias_bytes": mem_row["alias_bytes"] // m}
    mem["per_device_bytes"] = mem["argument_bytes"] + mem["temp_bytes"] \
        + mem["output_bytes"] - mem["alias_bytes"]
    mem["microbatch"] = {"grad_accum": accum,
                         "batch": shape.global_batch // accum}
    n_params, n_active = model.param_count(), model.active_param_count()
    flops, nbytes = hc["flops"], hc["traffic_bytes"]
    coll = {k: v["bytes"] for k, v in hc["collectives"].items()}
    coll_bytes = sum(coll.values())
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = {"train": 6, "prefill": 2, "decode": 2}[shape.kind]
    model_flops = mult * n_active * tokens
    compute_s = flops / HW["peak_flops_bf16"]
    memory_s = nbytes / HW["hbm_bw"]
    collective_s = coll_bytes / HW["nvlink_bw"]
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    result.update({
        "status": "OK",
        "counted": "per device on meta: one data row's counts over its "
                   "devices; layers extrapolated from one and two units; "
                   "terms over the datasheet rates, not measured",
        "device": HW["name"],
        "params": n_params,
        "active_params": n_active,
        "count_s": t_count,
        "memory": mem,
        "fits_one_card": mem["per_device_bytes"] <= HW["hbm_bytes"],
        "ops": hc["ops"],
        "kernels": hc["kernels"],
        "collectives": {
            "bytes_by_kind": coll,
            "counts": {k: v["count"] for k, v in hc["collectives"].items()},
            "total_bytes": coll_bytes,
        },
        "roofline": {
            "hlo_flops_per_device": flops,
            "hlo_bytes_per_device": nbytes,
            "collective_bytes_per_device": coll_bytes,
            "compute_term_s": compute_s,
            "memory_term_s": memory_s,
            "collective_term_s": collective_s,
            "dominant": dominant,
            "model_flops_total": model_flops,
            "hlo_flops_total": flops * n_chips,
            "useful_flops_ratio": model_flops / (flops * n_chips)
            if flops else 0.0,
        },
    })
    if verbose:
        print(f"[{mesh_name}] {arch} x {shape_name} ({rules_name}): count "
              f"{t_count:.1f}s | mem/dev {mem['per_device_bytes'] / 1e9:.2f}"
              f" GB | flops/dev {flops:.3e} | coll "
              f"{coll_bytes / 1e9:.3f} GB | dominant={dominant} | useful="
              f"{100 * result['roofline']['useful_flops_ratio']:.1f}% "
              f"(counted on meta)")
    return result


def artifact_path(out_dir: str, arch: str, shape_name: str,
                  mesh_name: str = MESH) -> str:
    d = os.path.join(out_dir, mesh_name)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch}__{shape_name}.json")


def table(results) -> str:
    """A markdown table of the cells (the one PERF.md keeps)."""
    rows = ["| arch x shape | params | argument GB | temp GB (microbatch) | "
            "per-device GB | FLOPs | bytes | compute s | memory s | "
            "dominant | fits one card |",
            "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | "
            "--- |"]
    for r in results:
        if r.get("status") != "OK":
            rows.append(f"| {r['arch']} x {r['shape']} | "
                        f"{r.get('status')}: "
                        f"{r.get('reason') or r.get('error')} |"
                        + " |" * 9)
            continue
        f, m = r["roofline"], r["memory"]
        rows.append(
            f"| {r['arch']} x {r['shape']} | {r['params']:,} | "
            f"{r['argument_bytes_total'] / 1e9:.2f} | "
            f"{m['temp_bytes'] / 1e9:.2f} ({m['microbatch']['batch']}) | "
            f"{m['per_device_bytes'] / 1e9:.2f} | {f['flops']:.4g} | "
            f"{f['traffic_bytes']:.4g} | {f['compute_term_s']:.4g} | "
            f"{f['memory_term_s']:.4g} | {f['dominant']} | "
            f"{'yes' if r['fits_one_card'] else 'no'} |")
    return "\n".join(rows)


def mesh_table(results) -> str:
    """A markdown table of production-mesh cells: per-device terms,
    counted on ``meta``."""
    rows = ["| mesh | arch x shape | rules | GB/device | FLOPs/device | "
            "bytes/device | collective bytes/device | compute s | memory s "
            "| collective s | dominant | useful |",
            "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | "
            "--- | --- |"]
    for r in results:
        if r.get("status") != "OK":
            rows.append(f"| {r['mesh']} | {r['arch']} x {r['shape']} | "
                        f"{r.get('status')}: "
                        f"{r.get('reason') or r.get('error')} |" + " |" * 9)
            continue
        f = r["roofline"]
        rows.append(
            f"| {r['mesh']} | {r['arch']} x {r['shape']} | {r['rules']} | "
            f"{r['memory']['per_device_bytes'] / 1e9:.2f} | "
            f"{f['hlo_flops_per_device']:.4g} | "
            f"{f['hlo_bytes_per_device']:.4g} | "
            f"{f['collective_bytes_per_device']:.4g} | "
            f"{f['compute_term_s']:.4g} | {f['memory_term_s']:.4g} | "
            f"{f['collective_term_s']:.4g} | {f['dominant']} | "
            f"{100 * f['useful_flops_ratio']:.1f}% |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every config of configs/ (13) x every shape")
    ap.add_argument("--force", action="store_true",
                    help="ignore cached artifacts")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) pod x data x model mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the (16, 16) and the (2, 16, 16) meshes")
    ap.add_argument("--rules", default=None,
                    choices=[None, "tp", "fsdp_tp", "long"],
                    help="override the cells' rules (production meshes)")
    args = ap.parse_args(argv)
    if not args.all and not args.arch:
        ap.error("give --arch or --all")
    if args.both_meshes:
        meshes = list(PROD_MESHES)
    elif args.multi_pod:
        meshes = ["h100_2x16x16"]
    elif args.rules:
        meshes = ["h100_16x16"]
    else:
        meshes = [MESH]

    archs = list(list_configs()) if args.all else [args.arch]
    shapes = [args.shape] if args.shape else list(SHAPES)
    failures, results = [], []
    for mesh_name in meshes:
        for arch in archs:
            for shape_name in shapes:
                path = artifact_path(args.out, arch, shape_name, mesh_name)
                if os.path.exists(path) and not args.force \
                        and args.rules is None:
                    print(f"cached: {path}")
                    with open(path) as f:
                        results.append(json.load(f))
                    continue
                try:
                    res = run_cell(arch, shape_name) if mesh_name == MESH \
                        else run_mesh_cell(arch, shape_name, mesh_name,
                                           args.rules)
                except Exception as e:       # record the cell and go on
                    traceback.print_exc()
                    res = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "status": "FAIL",
                           "error": f"{type(e).__name__}: {e}"}
                    failures.append((mesh_name, arch, shape_name))
                results.append(res)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
    one = [r for r in results if r.get("mesh") == MESH]
    many = [r for r in results if r.get("mesh") != MESH]
    if one:
        print(table(one))
    if many:
        print(mesh_table(many))
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
