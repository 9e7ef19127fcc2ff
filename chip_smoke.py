#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (any failure raises and the process exits non-zero):

1. the card: ``nvidia-smi`` name and power limit;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (cached
   under ``build/repro_torch_kernels/`` by a hash of the sources); print
   each kernel's registers, shared memory and spills as ptxas reported
   them, and fail unless the SASS of the bf16 (tensor-core) K1, K2 and K3
   kernels holds ``HMMA`` instructions and ptxas reports no spills there;
3. each kernel against its plain PyTorch version on the card, at the
   serving paths' shapes, with timings (kernel, plain version, one library
   call as a yardstick where one exists, and the card's least time for the
   same work): K1 and K2 at qwen2-0.5b's, K2 also at two long caches
   (B=16 T=4096 and the single straggler B=1 T=8192, under the record's
   ``long_context``), K3 at mamba2-2.7b's and at a ragged and a short
   sequence. ``ms`` times back-to-back calls from Python (the wrapper's
   host cost included); ``device_ms`` and ``library_device_ms`` time a
   CUDA graph of the same calls, the card's own time;
4. the serving path at full qwen2-0.5b width: a Router with two jobs'
   deployments on node group 0, four alternating batched ``generate``
   calls, with the kernels' launch counts set to 0 before and read after,
   then one more ``generate`` under the profiler (the ten largest device
   entries and every kernel of the port);
5. whole-path parity for qwen2-0.5b: prefill and teacher-forced decode
   logits on the card against the same parameters through the plain
   versions on the CPU;
6. the serving path at full mamba2-2.7b width and depth, as phase 4, on a
   new Router once the qwen2 one is released;
7. whole-path parity for mamba2-2.7b, as phase 5, at full depth.

The line before the last is the kernels' JSON record; the last line is the
device record ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the repository's ``src/`` beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import gc
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

SSD_Y_TOL, SSD_STATE_TOL = 2e-2, 1e-2   # as tests/test_kernels.py for K3

# the qwen2 serving path's shapes (batch 16, prompt 128, 64 new)
ARCH = "qwen2-0.5b"
B, P, N_NEW = 16, 128, 64
H, KH, D = 14, 2, 64
LAYERS = 24
# K2 at long caches (batch, capacity), timed at the last position: a full
# batch at 4096 and the RLVR long tail, one straggler at 8192
DECODE_LONG = ((16, 4096), (1, 8192))
# K2's queries at 3x unit scale: the softmax over a long cache is then sharp
# and the outputs O(1); at unit scale they shrink as sqrt(e / T), below the
# tolerance, where a kernel that lost a split would still pass
DECODE_Q_SCALE = 3.0

# the mamba2 serving path's shapes (batch 16, prompt 512, 64 new): 80 SSD
# heads of width 64, state 128, chunk 256, 64 layers
SSM_ARCH = "mamba2-2.7b"
SSM_P = 512
SSM_H, SSM_HD, SSM_N, SSM_CHUNK = 80, 64, 128, 256
SSM_LAYERS = 64


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


def device_ms(torch, fn, arg_sets, reps: int) -> float:
    """Mean device ms per call: the calls over ``arg_sets`` (rotated past
    the L2 cache) captured once into a CUDA graph after warm-up, the graph
    replayed ``reps`` times between two events. No host work is timed."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in arg_sets:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * len(arg_sets))
    del graph
    return ms


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
          f"{BF16_TOL}; |expect| max {expect.float().abs().max().item()}) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


# ------------------------------------------------------ phase 2: build

# the tensor-core kernels (bf16 routes), by the name their symbols carry
TENSOR_CORE_KERNELS = ("flash_fwd_tc", "decode_split_tc", "ssd_tc")
# every kernel of the port, for the profiled rounds
PORT_KERNELS = TENSOR_CORE_KERNELS + ("flash_fwd_kernel", "decode_kernel",
                                      "ssd_kernel")


def build_report(build):
    """ptxas's registers, shared memory and spills for each kernel, and the
    HMMA instructions in each kernel's SASS; fails unless every
    tensor-core kernel has HMMA and no spills."""
    lib_dir = build.build_dir() / build.source_hash()
    kernel, info = None, {}
    for line in (lib_dir / "nvcc.log").read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
            info[kernel] = {}
        elif kernel and "spill stores" in line:
            info[kernel]["spills"] = line.strip()
        elif kernel and "Used" in line and "registers" in line:
            info[kernel]["used"] = line.split("info    :")[-1].strip()
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_dir / build.LIB_NAME)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    hmma, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :")[1].strip()
            hmma[kernel] = 0
        elif kernel and "HMMA" in line:
            hmma[kernel] += 1
    for name in sorted(info):
        print(f"  {name}: {info[name].get('used')}; "
              f"{info[name].get('spills')}; HMMA {hmma.get(name, 0)}")
    for tag in TENSOR_CORE_KERNELS:
        names = [k for k in info if tag in k]
        if not names:
            fail(f"no {tag} kernel in the build")
        for name in names:
            if not hmma.get(name):
                fail(f"{name} has no HMMA in its SASS")
            if "0 bytes spill stores, 0 bytes spill loads" not in \
                    info[name].get("spills", ""):
                fail(f"{name} spills: {info[name].get('spills')}")


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

    def kernel(q, k, v):
        return ops.flash_attention(q, k, v, causal=True)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    t_kernel = time_ms(torch, kernel, sets, 200)
    t_plain = time_ms(torch, lambda q, k, v: ref.ref_attention(
        q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2),
        causal=True), sets, 50)
    t_lib = time_ms(torch, sdpa, sets, 200)
    d_kernel = device_ms(torch, kernel, sets, 20)
    d_lib = device_ms(torch, sdpa, sets, 20)
    flops = 4 * B * H * D * P * (P + 1) // 2     # row s sees s + 1 keys
    t_bound, by = bound(per_call, flops)
    print(f"  timing B={B} S={P} causal: kernel {t_kernel} ms (device "
          f"{d_kernel} ms), plain {t_plain} ms, sdpa {t_lib} ms (device "
          f"{d_lib} ms), bound {t_bound} ms ({by}: {per_call} B, {flops} "
          f"FLOP)")
    records["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:88",
        max_abs_err=max(errs), ms=t_kernel, device_ms=d_kernel,
        plain_ms=t_plain, bound_ms=t_bound, bound_by=by, library_ms=t_lib,
        library_device_ms=d_lib)

    # K2 decode: the serving shape's check and timing, then two long caches
    t_cap = P + N_NEW
    print("phase 3: K2 decode_attention vs plain (bf16)")
    errs = []
    q, kc, vc = (DECODE_Q_SCALE * randn(B, H, D), randn(B, t_cap, KH, D),
                 randn(B, t_cap, KH, D))
    for pos in (0, P - 1, t_cap - 1):
        out = ops.decode_attention(q, kc, vc, pos)
        expect = ref.ref_decode_attention(q, kc, vc, pos)
        errs.append(check_close(torch, f"B={B} T={t_cap} H={H} K={KH} D={D} "
                                f"pos={pos}", out, expect))
    # the last, longest decode step of the serving path
    serving = decode_timing(torch, randn, B, t_cap, t_cap - 1, 500)
    long_rows = [decode_timing(torch, randn, b, t, t - 1, 200)
                 for b, t in DECODE_LONG]
    records["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:66",
        max_abs_err=max(errs + [serving.pop("max_abs_err")]), **serving,
        long_context=long_rows)
    return records


def decode_timing(torch, randn, b, t_cap, pos, iters):
    """K2 at one shape: checked against its plain version, then timed
    (kernel, plain, SDPA; host-timed and as a CUDA graph) beside its bound,
    the caches rotated past the L2 cache."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    # q read and the output written once; K and V cache rows 0..pos read
    per_call = (2 * b * H * D + 2 * b * (pos + 1) * KH * D) * 2
    sets = [(DECODE_Q_SCALE * randn(b, H, D), randn(b, t_cap, KH, D),
             randn(b, t_cap, KH, D)) for _ in range(n_sets(per_call))]
    q, kc, vc = sets[0]
    err = check_close(torch, f"B={b} T={t_cap} H={H} K={KH} D={D} pos={pos}",
                      ops.decode_attention(q, kc, vc, pos),
                      ref.ref_decode_attention(q, kc, vc, pos))

    def kernel(q, k, v):
        return ops.decode_attention(q, k, v, pos)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q[:, :, None], k[:, :pos + 1].transpose(1, 2),
            v[:, :pos + 1].transpose(1, 2), enable_gqa=True)

    reps = max(50, 1000 // len(sets))
    t_kernel = time_ms(torch, kernel, sets, iters)
    t_plain = time_ms(torch, lambda q, k, v: ref.ref_decode_attention(
        q, k, v, pos), sets, iters // 5)
    t_lib = time_ms(torch, sdpa, sets, iters)
    d_kernel = device_ms(torch, kernel, sets, reps)
    d_lib = device_ms(torch, sdpa, sets, reps)
    flops = 4 * b * H * D * (pos + 1)
    t_bound, by = bound(per_call, flops)
    print(f"  timing B={b} T={t_cap} pos={pos}: kernel {t_kernel} ms "
          f"(device {d_kernel} ms), plain {t_plain} ms, sdpa {t_lib} ms "
          f"(device {d_lib} ms), bound {t_bound} ms ({by}: {per_call} B, "
          f"{flops} FLOP)")
    return dict(shape=f"B={b} T={t_cap} H={H} K={KH} D={D} pos={pos}",
                max_abs_err=err, ms=t_kernel, device_ms=d_kernel,
                plain_ms=t_plain, bound_ms=t_bound, bound_by=by,
                library_ms=t_lib, library_device_ms=d_lib)


def ssd_flops(b, s, h, p, n, chunk) -> int:
    """Operations of the chunk scan, counting each chunk's causal half of
    the scores: C.B and the scores times x over the pairs j <= i, the
    carried state's C S, and the state update."""
    total = 0
    for t0 in range(0, s, chunk):
        lc = min(chunk, s - t0)
        pairs = lc * (lc + 1) // 2
        total += 2 * pairs * (n + p) + 2 * 2 * lc * n * p
    return b * h * total


def ssd_kernel_phase(torch, dev):
    """K3 against ref_ssd at the mamba2 prefill shape, a ragged sequence and
    one shorter than a chunk: bf16 x, B and C as the model passes them."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(1)
    b, h, p, n = B, SSM_H, SSM_HD, SSM_N

    def inputs(s):
        x = torch.randn((b, s, h, p), generator=gen, device=dev)
        dt = F.softplus(torch.randn((b, s, h), generator=gen, device=dev))
        A = -torch.exp(torch.randn((h,), generator=gen, device=dev))
        Bm = torch.randn((b, s, 1, n), generator=gen, device=dev)
        Cm = torch.randn((b, s, 1, n), generator=gen, device=dev)
        return (x.to(torch.bfloat16), dt, A, Bm.to(torch.bfloat16),
                Cm.to(torch.bfloat16))

    print("phase 3: K3 ssd chunk scan vs plain (bf16 x, B, C; f32 dt, A)")
    errs = []
    for label, s in (("prefill", SSM_P), ("ragged", 300), ("short", 100)):
        args = inputs(s)
        y, st = ops.ssd(*args, chunk=SSM_CHUNK)
        ye, ste = ref.ref_ssd(*args, chunk=min(SSM_CHUNK, s))
        y_err = (y.float() - ye.float()).abs().max().item()
        st_err = (st - ste).abs().max().item()
        ok = torch.allclose(y.float(), ye.float(), rtol=SSD_Y_TOL,
                            atol=SSD_Y_TOL) and torch.allclose(
            st, ste, rtol=SSD_STATE_TOL, atol=SSD_STATE_TOL)
        print(f"  B={b} S={s} H={h} P={p} N={n} chunk={min(SSM_CHUNK, s)} "
              f"{label}: y max_abs_err {y_err} (rtol=atol={SSD_Y_TOL}, |y| "
              f"max {ye.float().abs().max().item()}), state max_abs_err "
              f"{st_err} (rtol=atol={SSD_STATE_TOL}) "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"ssd {label} disagrees with its plain version")
        errs.append(y_err)
    # x, dt, B, C (and A) read once; y and the f32 final state written once
    per_call = (2 * b * SSM_P * h * p * 2 + b * SSM_P * h * 4
                + 2 * b * SSM_P * n * 2 + h * 4 + b * h * p * n * 4)
    sets = [inputs(SSM_P) for _ in range(n_sets(per_call))]
    def kernel(*a):
        return ops.ssd(*a, chunk=SSM_CHUNK)

    t_kernel = time_ms(torch, kernel, sets, 20)
    t_plain = time_ms(torch, lambda *a: ref.ref_ssd(*a, chunk=SSM_CHUNK),
                      sets, 4)
    d_kernel = device_ms(torch, kernel, sets, 10)
    flops = ssd_flops(b, SSM_P, h, p, n, SSM_CHUNK)
    t_bound, by = bound(per_call, flops)
    print(f"  timing B={b} S={SSM_P}: kernel {t_kernel} ms (device "
          f"{d_kernel} ms), plain {t_plain} ms, no library call computes an "
          f"SSD scan, bound {t_bound} ms ({by}: {per_call} B, {flops} FLOP)")
    return {"ssd": dict(
        name="ssd", route="cuda", source="src/repro_torch/kernels/csrc/ssd.cu",
        replaces="src/repro/kernels/ssd.py:87", max_abs_err=max(errs),
        ms=t_kernel, device_ms=d_kernel, plain_ms=t_plain, bound_ms=t_bound,
        bound_by=by, library_ms=None, library_device_ms=None)}


# ------------------------------------------------ phases 4, 6: serving

def profile_round(torch, dep, prompts, n_new):
    """One more generate of the resident job (no context switch) with the
    device traced: the card's busy share and its kernel time by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dep.generate(prompts, max_new_tokens=n_new,
                     temperature=0.7).wait(timeout=600)
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    print(f"  profiled round: {wall * 1e3} ms wall, device busy {busy * 1e3} "
          f"ms ({busy / wall} of wall), {sum(e.count for e in events)} "
          f"device events")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # the ten largest, then the port's own kernels wherever they rank
    for i, e in enumerate(ranked):
        if i < 10 or any(tag in e.key for tag in PORT_KERNELS):
            print(f"    {e.self_device_time_total / 1e3} ms  x{e.count}  "
                  f"{e.key[:90]}")


def f32_leaves(torch, dep):
    """Copies of a deployment's f32 parameters, wherever they live now."""
    from repro_torch.models import common
    return {k: v.detach().cpu().clone() for k, v in
            common.canonical_flat(dep.wpg.params()).items()
            if v.dtype == torch.float32}


def serve_phase(torch, dev, phase, arch, prompt_len, want):
    """Two jobs' deployments of ``arch`` on group 0, four alternating
    generates. ``want``: the launches each generate must make, per kernel;
    the counts are set to 0 just before the four rounds and read just
    after."""
    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.core.router import Router
    from repro_torch.kernels import ops
    from repro_torch.rl import data as data_lib

    vocab = get_config(arch).vocab_size
    print(f"phase {phase}: serving {arch} at full width, jobs A and B on "
          f"group 0 (B={B}, prompt {prompt_len}, {N_NEW} new, temperature "
          f"0.7)")
    router = Router()                 # the CUDA devices; one card here
    deps = {job: router.deploy(api.DeploymentSpec(
        deployment_id=f"rollout-{job}", job_id=job, model_name=arch,
        role="rollout", overrides=()), group_id=0) for job in "AB"}
    batches = data_lib.MathDataset(seed=0).batches(B, prompt_len)
    prompts = [next(batches)[0] for _ in range(4)]
    with router:
        for seed, dep in enumerate(deps.values(), start=1):
            info = dep.init(seed=seed).wait(timeout=600)
        print(f"  params per deployment: {info['params']}; card memory "
              f"allocated {torch.cuda.memory_allocated(dev)} B")
        kept = {job: f32_leaves(torch, dep) for job, dep in deps.items()}
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
            if grew != want:
                fail(f"round {r}: launches {grew}, want {want}")
            live = int(out["alive"].sum())
            print(f"  round {r} job {job}: {dt * 1e3} ms, {B * N_NEW} tokens "
                  f"({live} live), {B * N_NEW / dt} tok/s, launches {grew}")
        launches = dict(ops.LAUNCHES)
        print(f"  peak card memory {torch.cuda.max_memory_allocated(dev)} B")
        profile_round(torch, deps["B"], prompts[0], N_NEW)
    switches = router.switch_log
    for s in switches:
        print(f"  switch to {s['to_job']}: offload {s['t_offload']} s, "
              f"load {s['t_load']} s")
    # the log also records a target load with nothing to offload, as the
    # reference router does: count the switches that moved the other job
    moved = [s for s in switches if s["t_offload"] > 0]
    if len(moved) < 3:
        fail(f"only {len(moved)} context switches offloaded a job")
    for job, dep in deps.items():
        back = f32_leaves(torch, dep)
        if back.keys() != kept[job].keys() or not all(
                torch.equal(back[k], v) for k, v in kept[job].items()):
            fail(f"job {job}: f32 parameters changed across the host tier")
        print(f"  exec_log {dep.deployment_id}: {list(dep.wpg.exec_log)}; "
              f"{len(back)} f32 leaves bit-exact after the switches")
    return router, launches


# ------------------------------------------------ phases 5, 7: parity

def parity_phase(torch, router, dev, phase):
    """Prefill and teacher-forced decode logits on the card against the
    same parameters through the plain versions on the CPU."""
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
    print(f"phase {phase}: parity card vs CPU plain, {cfg.name} at "
          f"{cfg.num_layers} layers, B={b} P={p}, {n} teacher-forced decode "
          f"steps (tolerance {rel_tol} * max|logit|)")
    logits = {}
    with torch.inference_mode():
        for where, d in runs.items():
            t0 = time.perf_counter()
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
            print(f"  {where} side: {time.perf_counter() - t0} s")
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


def path_launches(records, launches, want):
    """Write the path's launch counts into the records; fail where a kernel
    of the path was never launched."""
    for name, per_round in want.items():
        if per_round == 0:
            continue
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on its serving path")
        records[name]["launches"] = launches[name]


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"phase 1: card {card}")
    t0 = time.monotonic()
    build.load()
    print(f"phase 2: kernels built in {time.monotonic() - t0} s "
          f"(nvcc {build.build_seconds} s; None = cached)")
    build_report(build)
    records = kernel_phase(torch, dev)
    records.update(ssd_kernel_phase(torch, dev))

    want = {"flash_attention": LAYERS, "decode_attention": LAYERS * N_NEW,
            "ssd": 0}
    router, launches = serve_phase(torch, dev, 4, ARCH, P, want)
    path_launches(records, launches, want)
    parity_phase(torch, router, dev, 5)
    # release the qwen2 deployments (device and pinned host memory)
    del router
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    print(f"  qwen2 router released: card memory allocated "
          f"{torch.cuda.memory_allocated(dev)} B")

    want = {"flash_attention": 0, "decode_attention": 0, "ssd": SSM_LAYERS}
    router, launches = serve_phase(torch, dev, 6, SSM_ARCH, SSM_P, want)
    path_launches(records, launches, want)
    parity_phase(torch, router, dev, 7)
    del router
    print(f"all phases passed in {time.monotonic() - t_start} s")
    print(card)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
