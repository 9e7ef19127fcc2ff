#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (any failure raises and the process exits non-zero):

1. the card: ``nvidia-smi`` name and power limit;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (cached
   under ``build/repro_torch_kernels/`` by a hash of the sources);
3. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes, with timings (kernel, plain version, one library
   call as a yardstick, and the card's least time for the same work);
4. the serving path at full qwen2-0.5b width: a Router with two jobs'
   deployments on node group 0, four alternating batched ``generate``
   calls, with the kernels' launch counts read around them;
5. whole-path parity: prefill and teacher-forced decode logits on the card
   against the same parameters through the plain versions on the CPU.

The line before the last is the kernels' JSON record; the last line is the
device record ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the repository's ``src/`` beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# published H100 SXM peaks: HBM3 bandwidth and dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
BF16_TOL = 5e-2           # rtol = atol, as tests/test_kernels.py for bf16
L2_BYTES = 50 * 2 ** 20   # rotate inputs past the L2 cache when timing

# the serving path's shapes (qwen2-0.5b, batch 16, prompt 128, 64 new)
ARCH = "qwen2-0.5b"
B, P, N_NEW = 16, 128, 64
H, KH, D = 14, 2, 64
LAYERS = 24


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- timing

def time_ms(torch, fn, arg_sets, iters: int) -> float:
    """Mean device ms per call over ``iters`` warmed calls, cycling through
    ``arg_sets`` so each call finds its inputs outside the L2 cache."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def n_sets(bytes_per_call: int) -> int:
    return max(2, math.ceil(2 * L2_BYTES / bytes_per_call))


def bound(nbytes: int, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(torch, name, out, expect) -> float:
    err = (out.float() - expect.float()).abs().max().item()
    ok = torch.allclose(out.float(), expect.float(), rtol=BF16_TOL,
                        atol=BF16_TOL)
    print(f"  {name}: max_abs_err {err} (bf16 tolerance rtol=atol="
          f"{BF16_TOL}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


# ----------------------------------------------------- phase 3: kernels

def kernel_phase(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    records = {}

    # K1 flash prefill
    print("phase 3: K1 flash_attention vs plain (bf16)")
    errs = []
    cases = [("causal", P, dict(causal=True)),
             ("window 64", P, dict(causal=True, window=64)),
             ("softcap 50 scale 0.125", P,
              dict(causal=True, softcap=50.0, scale=0.125)),
             ("ragged S=200", 200, dict(causal=True))]
    for label, s, kw in cases:
        q, k, v = randn(B, s, H, D), randn(B, s, KH, D), randn(B, s, KH, D)
        out = ops.flash_attention(q, k, v, **kw)
        expect = ref.ref_attention(q, k.repeat_interleave(H // KH, 2),
                                   v.repeat_interleave(H // KH, 2), **kw)
        errs.append(check_close(torch, f"B={B} S={s} H={H} K={KH} D={D} "
                                f"{label}", out, expect))
    # q, k, v read once and the output written once, bf16
    per_call = (2 * B * P * H * D + 2 * B * P * KH * D) * 2
    sets = [(randn(B, P, H, D), randn(B, P, KH, D), randn(B, P, KH, D))
            for _ in range(n_sets(per_call))]
    g = H // KH
    t_kernel = time_ms(torch, lambda q, k, v: ops.flash_attention(
        q, k, v, causal=True), sets, 200)
    t_plain = time_ms(torch, lambda q, k, v: ref.ref_attention(
        q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2),
        causal=True), sets, 50)
    t_lib = time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True), sets, 200)
    flops = 4 * B * H * D * P * (P + 1) // 2     # row s sees s + 1 keys
    t_bound, by = bound(per_call, flops)
    print(f"  timing B={B} S={P} causal: kernel {t_kernel} ms, plain "
          f"{t_plain} ms, sdpa {t_lib} ms, bound {t_bound} ms ({by}: "
          f"{per_call} B, {flops} FLOP)")
    records["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:88",
        max_abs_err=max(errs), ms=t_kernel, plain_ms=t_plain,
        bound_ms=t_bound, bound_by=by, library_ms=t_lib)

    # K2 decode
    t_cap = P + N_NEW
    print("phase 3: K2 decode_attention vs plain (bf16)")
    errs = []
    q, kc, vc = randn(B, H, D), randn(B, t_cap, KH, D), randn(B, t_cap, KH, D)
    for pos in (0, P - 1, t_cap - 1):
        out = ops.decode_attention(q, kc, vc, pos)
        expect = ref.ref_decode_attention(q, kc, vc, pos)
        errs.append(check_close(torch, f"B={B} T={t_cap} H={H} K={KH} D={D} "
                                f"pos={pos}", out, expect))
    pos = t_cap - 1                     # the last, longest decode step
    # q read and the output written once; K and V cache rows 0..pos read
    per_call = (2 * B * H * D + 2 * B * (pos + 1) * KH * D) * 2
    sets = [(randn(B, H, D), randn(B, t_cap, KH, D), randn(B, t_cap, KH, D))
            for _ in range(n_sets(per_call))]
    t_kernel = time_ms(torch, lambda q, k, v: ops.decode_attention(
        q, k, v, pos), sets, 500)
    t_plain = time_ms(torch, lambda q, k, v: ref.ref_decode_attention(
        q, k, v, pos), sets, 100)
    t_lib = time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
        q[:, :, None], k[:, :pos + 1].transpose(1, 2),
        v[:, :pos + 1].transpose(1, 2), enable_gqa=True), sets, 500)
    flops = 4 * B * H * D * (pos + 1)
    t_bound, by = bound(per_call, flops)
    print(f"  timing B={B} T={t_cap} pos={pos}: kernel {t_kernel} ms, plain "
          f"{t_plain} ms, sdpa {t_lib} ms, bound {t_bound} ms ({by}: "
          f"{per_call} B, {flops} FLOP)")
    records["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:66",
        max_abs_err=max(errs), ms=t_kernel, plain_ms=t_plain,
        bound_ms=t_bound, bound_by=by, library_ms=t_lib)
    return records


# ------------------------------------------------ phase 4: serving path

def profile_round(torch, dep, prompts):
    """One more generate of the resident job (no context switch) with the
    device traced: the card's busy share and its kernel time by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dep.generate(prompts, max_new_tokens=N_NEW,
                     temperature=0.7).wait(timeout=600)
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    print(f"  profiled round: {wall * 1e3} ms wall, device busy {busy * 1e3} "
          f"ms ({busy / wall} of wall), {sum(e.count for e in events)} "
          f"device events")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"    {e.self_device_time_total / 1e3} ms  x{e.count}  "
              f"{e.key[:90]}")


def serve_phase(torch, dev, vocab: int):
    from repro_torch.core import api
    from repro_torch.core.router import Router
    from repro_torch.kernels import ops
    from repro_torch.rl import data as data_lib

    print(f"phase 4: serving {ARCH} at full width, jobs A and B on group 0")
    router = Router()                 # the CUDA devices; one card here
    deps = {job: router.deploy(api.DeploymentSpec(
        deployment_id=f"rollout-{job}", job_id=job, model_name=ARCH,
        role="rollout", overrides=()), group_id=0) for job in "AB"}
    batches = data_lib.MathDataset(seed=0).batches(B, P)
    prompts = [next(batches)[0] for _ in range(4)]
    with router:
        for seed, dep in enumerate(deps.values(), start=1):
            info = dep.init(seed=seed).wait(timeout=600)
        print(f"  params per deployment: {info['params']}")
        ops.reset_launches()
        for r, job in enumerate("ABAB"):
            before = dict(ops.LAUNCHES)
            t0 = time.perf_counter()
            out = deps[job].generate(prompts[r], max_new_tokens=N_NEW,
                                     temperature=0.7).wait(timeout=600)
            dt = time.perf_counter() - t0
            grew = {k: ops.LAUNCHES[k] - before[k] for k in before}
            toks, logps = out["tokens"], out["logprobs"]
            if tuple(toks.shape) != (B, N_NEW) or toks.device.type != dev.type:
                fail(f"round {r}: tokens {tuple(toks.shape)} {toks.device}")
            if not bool(((toks >= 0) & (toks < vocab)).all()):
                fail(f"round {r}: token outside the vocab")
            if not bool(torch.isfinite(logps).all()):
                fail(f"round {r}: non-finite logprobs")
            if grew != {"flash_attention": LAYERS,
                        "decode_attention": LAYERS * N_NEW}:
                fail(f"round {r}: launches {grew}, want {LAYERS} K1 and "
                     f"{LAYERS * N_NEW} K2")
            live = int(out["alive"].sum())
            print(f"  round {r} job {job}: {dt * 1e3} ms, {B * N_NEW} tokens "
                  f"({live} live), {B * N_NEW / dt} tok/s, launches {grew}")
        launches = dict(ops.LAUNCHES)
        profile_round(torch, deps["B"], prompts[0])
    switches = router.switch_log
    for s in switches:
        print(f"  switch to {s['to_job']}: offload {s['t_offload']} s, "
              f"load {s['t_load']} s")
    # the log also records a target load with nothing to offload, as the
    # reference router does: count the switches that moved the other job
    moved = [s for s in switches if s["t_offload"] > 0]
    if len(moved) < 3:
        fail(f"only {len(moved)} context switches offloaded a job")
    for dep in deps.values():
        print(f"  exec_log {dep.deployment_id}: {list(dep.wpg.exec_log)}")
    return router, launches


# --------------------------------------------- phase 5: whole-path parity

def parity_phase(torch, router, dev):
    from repro_torch.models import common
    from repro_torch.rl import data as data_lib
    from repro_torch.rl.rollout import _pad_cache

    wpg = router.wpgs["rollout-A"]
    model, cfg = wpg.model, wpg.cfg
    params = wpg.params()
    runs = {"card": dev, "cpu": torch.device("cpu")}
    b, p, n = 2, 64, 8
    prompt = torch.as_tensor(next(data_lib.MathDataset(seed=1).batches(b, p))[0],
                             dtype=torch.long)
    forced = torch.randint(0, cfg.vocab_size, (b, n),
                           generator=torch.Generator().manual_seed(2))
    # the CPU test's bound of four bf16 ulps of the largest logit at 4
    # layers (tests/test_torch_model.py), grown with the square root of the
    # depth: independent bf16 roundings per layer add in quadrature
    rel_tol = 2.0 ** -6 * math.sqrt(cfg.num_layers / 4)
    print(f"phase 5: parity card vs CPU plain, B={b} P={p}, {n} "
          f"teacher-forced decode steps (tolerance {rel_tol} * max|logit|)")
    logits, caches = {}, {}
    with torch.inference_mode():
        for where, d in runs.items():
            prm = common.tree_map(lambda t: t.to(d), params,
                                  is_leaf=torch.is_tensor)
            lg, _, cache = model.forward(prm, {"tokens": prompt.to(d)},
                                         return_cache=True)
            steps = [lg.cpu()]
            cache = _pad_cache(cache, n)
            for i in range(n):
                lg, cache = model.decode_step(
                    prm, cache, {"tokens": forced[:, i:i + 1].to(d)})
                steps.append(lg.cpu())
            logits[where] = steps
    worst = 0.0
    for i, (gpu, cpu) in enumerate(zip(logits["card"], logits["cpu"])):
        err = (gpu - cpu).abs().max().item()
        tol = rel_tol * cpu.abs().max().item()
        worst = max(worst, err / tol)
        agree = (gpu.argmax(-1) == cpu.argmax(-1)).float().mean().item()
        label = "prefill" if i == 0 else f"decode {i}"
        print(f"  {label}: max|diff| {err}, tolerance {tol}, argmax "
              f"agreement {agree}")
        if not (torch.isfinite(gpu).all() and err <= tol):
            fail(f"parity {label}: {err} > {tol}")
    return worst


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"phase 1: card {card}")
    t0 = time.monotonic()
    build.load()
    print(f"phase 2: kernels built in {time.monotonic() - t0} s "
          f"(nvcc {build.build_seconds} s; None = cached)")
    records = kernel_phase(torch, dev)
    router, launches = serve_phase(torch, dev, get_config(ARCH).vocab_size)
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the serving path")
        records[name]["launches"] = n
    parity_phase(torch, router, dev)
    print(card)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
