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

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--force]

Artifacts: ``<out>/h100x1/<arch>__<shape>.json`` (``--out``, default
``build/repro_torch_dryrun/``); a cell already written is skipped unless
``--force``. ``--multi-pod``, ``--both-meshes`` and ``--rules`` need
sharding, which is not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.configs import SHAPES, ShapeSpec, get_config, list_configs
from repro_torch.configs import shape_applicable
from repro_torch.launch import hlo_cost
from repro_torch.launch.mesh import HW
from repro_torch.models.registry import build_model
from repro_torch.models.sharding import not_ported
from repro_torch.rl import grpo
from repro_torch.train import train_state as ts

MESH = "h100x1"
OUT_DIR = "build/repro_torch_dryrun"

# the reference's ZeRO-offload models: their train cells lower the gradient
# step and the optimizer runs on the host (StateManager, paper §4.5.4)
HOST_OPTIM = {"arctic-480b", "paper-qwen3-235b-a22b"}


def _not_ported(flag: str):
    return not_ported(f"the dry run's {flag} (per-device counts on meta)", 5)


def tree_bytes(tree) -> int:
    """Bytes of the tensors in a nested dict / tuple tree."""
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


def default_grad_accum(arch: str, shape: ShapeSpec) -> int:
    """The reference's microbatch count (``repro/launch/dryrun.py:63``) on
    one device: doubled while a microbatch's saved activations, 2.5 bf16
    copies of the residual stream a layer, pass 6 GB."""
    if shape.kind != "train":
        return 1
    cfg = get_config(arch)
    b_local = max(1, shape.global_batch)
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
        if isinstance(x, torch.Tensor):
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


def artifact_path(out_dir: str, arch: str, shape_name: str) -> str:
    d = os.path.join(out_dir, MESH)
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every config of configs/ (13) x every shape")
    ap.add_argument("--force", action="store_true",
                    help="ignore cached artifacts")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--rules", default=None)
    args = ap.parse_args(argv)
    for flag, given in (("--multi-pod", args.multi_pod),
                        ("--both-meshes", args.both_meshes),
                        ("--rules", args.rules is not None)):
        if given:
            raise _not_ported(flag)
    if not args.all and not args.arch:
        ap.error("give --arch or --all")

    archs = list(list_configs()) if args.all else [args.arch]
    shapes = [args.shape] if args.shape else list(SHAPES)
    failures, results = [], []
    for arch in archs:
        for shape_name in shapes:
            path = artifact_path(args.out, arch, shape_name)
            if os.path.exists(path) and not args.force:
                print(f"cached: {path}")
                with open(path) as f:
                    results.append(json.load(f))
                continue
            try:
                res = run_cell(arch, shape_name)
            except Exception as e:       # record the cell and go on
                traceback.print_exc()
                res = {"arch": arch, "shape": shape_name, "mesh": MESH,
                       "status": "FAIL", "error": f"{type(e).__name__}: {e}"}
                failures.append((arch, shape_name))
            results.append(res)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
    print(table(results))
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
