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
   print how many clusters of K2's bf16 route stay resident at each head
   dim (64, 112, 128) for 1 split and for the most, and fail at 0;
3. each kernel against its plain PyTorch version on the card, at the
   serving paths' shapes, with timings (kernel, plain version, one library
   call as a yardstick where one exists, and the card's least time for the
   same work): K1 and K2 at qwen2-0.5b's, K2 also at two long caches
   (B=16 T=4096 and the single straggler B=1 T=8192, under the record's
   ``long_context``), K3 at mamba2-2.7b's and at a ragged and a short
   sequence; then K1, K2 and K3 at zamba2-7b's shapes (under each record's
   ``zamba2``: head_dim 112, MHA; state 64), K1's and K2's queries at 3x
   unit scale (``Q_SCALE``). ``ms`` times back-to-back
   calls from Python (the wrapper's host cost included); ``device_ms`` and
   ``library_device_ms`` time a CUDA graph of the same calls, the card's
   own time;
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
7. whole-path parity for mamba2-2.7b, as phase 5, at full depth;
8. the GRPO training path at full qwen2-0.5b width and depth, on a new
   Router once the mamba2 one is released: jobs A and B as
   ``RLControllerGRPO`` on group 0, two steps each (generate -> pack ->
   update_actor), submitted round-robin and drained as
   ``PlexCluster.run(interleave=True)`` does, with each op's seconds and
   kernel launches, every context switch's seconds and bytes (parameters
   and f32 AdamW moments), the steps' metrics and the peak card memory;
   then one ``update_actor`` on a seeded batch with non-zero advantages
   (the gradient is non-zero, the moments change, the job's tensors are
   updated in place) and one more under the profiler;
9. training parity: one ``update_actor`` on the card against the same
   one on the CPU's plain path, at full width and 4 layers (the tied
   embedding scaled by 1/64, so the random policy is not one-hot), and
   K1's autograd Function against plain autograd through the XLA-branch
   attention at the training shape;
10. the serving path at full zamba2-7b width and depth (81 blocks: K3 in
    each of the 70 Mamba2 blocks' prefill, K1 in each of the 11
    applications of the shared attention block, K2 in each application's
    decode), as phase 6, once every earlier router and the pinned host
    buffers they held are released;
11. whole-path parity for zamba2-7b, as phase 5, at full width cut to 15
    blocks (2 applications, 1 trailing block) for the CPU side.

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
# K1's and K2's queries at 3x unit scale: the softmax over many keys is then
# sharp and the outputs O(1); at unit scale a row over T keys shrinks as
# sqrt(e / T), below the tolerance, where a kernel that lost a split, a key
# chunk or a k-step would still pass
Q_SCALE = 3.0

# the mamba2 serving path's shapes (batch 16, prompt 512, 64 new): 80 SSD
# heads of width 64, state 128, chunk 256, 64 layers
SSM_ARCH = "mamba2-2.7b"
SSM_P = 512
SSM_H, SSM_HD, SSM_N, SSM_CHUNK = 80, 64, 128, 256
SSM_LAYERS = 64

# the zamba2 serving path's shapes (batch 16, prompt 512, 64 new): 81 blocks,
# 11 applications of the shared attention block (32 heads of width 112,
# MHA) and 70 Mamba2 blocks (112 SSD heads of width 64, state 64, chunk 256);
# its parity phase cuts depth to 15 blocks (2 applications, 1 trailing block)
HYB_ARCH = "zamba2-7b"
HYB_P = 512
HYB_H, HYB_D = 32, 112
HYB_SSM_H, HYB_SSM_N = 112, 64
HYB_APPS, HYB_MAMBA = 11, 70
HYB_PARITY_LAYERS = 15


# the training path (phase 8): two GRPO jobs, as JobConfig fields, at the
# full config (TRAIN_OVERRIDES empty); phase 9's parity cuts depth only
TRAIN = dict(batch_size=16, group_size=4, prompt_len=64, max_new_tokens=64,
             seq_len=128, steps=2)
TRAIN_OVERRIDES = ()
PARITY_LAYERS, PARITY_B, PARITY_S = 4, 4, 128
TRAIN_LR = dict(lr=1e-3, warmup_steps=1)   # a step above a bf16 ulp


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


def cluster_report():
    """K2's bf16 route at each head dim: how many clusters of 1 split (the
    zamba2 decode's) and of the most splits stay resident at once; fails
    where none would."""
    from repro_torch.kernels import decode_attention as dec

    for d in dec.HEAD_DIMS:
        counts = {n: dec.max_active_clusters(d, n)
                  for n in (1, dec.MAX_SPLITS)}
        print(f"  decode_split_tc<{d}>: resident clusters by split count "
              f"{counts}")
        if not all(counts.values()):
            fail(f"decode_split_tc<{d}>: a cluster cannot be resident")


# ----------------------------------------------------- phase 3: kernels

def kernel_phase(torch, dev):
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
        q, k, v = (Q_SCALE * randn(B, s, H, D), randn(B, s, KH, D),
                   randn(B, s, KH, D))
        out = ops.flash_attention(q, k, v, **kw)
        expect = ref.ref_attention(q, k.repeat_interleave(H // KH, 2),
                                   v.repeat_interleave(H // KH, 2), **kw)
        errs.append(check_close(torch, f"B={B} S={s} H={H} K={KH} D={D} "
                                f"{label}", out, expect))
    timing = flash_timing(torch, randn, B, P, H, KH, D)
    timing.pop("shape")
    records["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:88",
        max_abs_err=max(errs + [timing.pop("max_abs_err")]), **timing)

    # K2 decode: the serving shape's check and timing, then two long caches
    t_cap = P + N_NEW
    print("phase 3: K2 decode_attention vs plain (bf16)")
    errs = []
    q, kc, vc = (Q_SCALE * randn(B, H, D), randn(B, t_cap, KH, D),
                 randn(B, t_cap, KH, D))
    for pos in (0, P - 1, t_cap - 1):
        out = ops.decode_attention(q, kc, vc, pos)
        expect = ref.ref_decode_attention(q, kc, vc, pos)
        errs.append(check_close(torch, f"B={B} T={t_cap} H={H} K={KH} D={D} "
                                f"pos={pos}", out, expect))
    # the last, longest decode step of the serving path
    serving = decode_timing(torch, randn, B, t_cap, t_cap - 1, 500)
    serving.pop("shape")
    long_rows = [decode_timing(torch, randn, b, t, t - 1, 200)
                 for b, t in DECODE_LONG]
    records["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:66",
        max_abs_err=max(errs + [serving.pop("max_abs_err")]), **serving,
        long_context=long_rows)

    # zamba2's shared attention block: K1 at its prefill, K2 at the last
    # step of its decode (MHA, head_dim 112)
    print("phase 3: K1 and K2 at zamba2's shapes (bf16, MHA, D=112)")
    t_cap = HYB_P + N_NEW
    records["flash_attention"]["zamba2"] = flash_timing(
        torch, randn, B, HYB_P, HYB_H, HYB_H, HYB_D, iters=50)
    records["decode_attention"]["zamba2"] = decode_timing(
        torch, randn, B, t_cap, t_cap - 1, 200, HYB_H, HYB_H, HYB_D)
    for name in ("flash_attention", "decode_attention"):
        rec = records[name]
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 rec["zamba2"]["max_abs_err"])
    return records


def flash_timing(torch, randn, b, s, h, kh, d, iters=200):
    """K1 causal at one shape: checked against its plain version, then
    timed (kernel, plain, SDPA; host-timed and as a CUDA graph) beside its
    bound, the inputs rotated past the L2 cache."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    g = h // kh
    # q, k, v read once and the output written once, bf16
    per_call = (2 * b * s * h * d + 2 * b * s * kh * d) * 2
    sets = [(Q_SCALE * randn(b, s, h, d), randn(b, s, kh, d),
             randn(b, s, kh, d)) for _ in range(n_sets(per_call))]
    q, k, v = sets[0]
    shape = f"B={b} S=T={s} H={h} K={kh} D={d} causal"
    err = check_close(torch, shape, ops.flash_attention(q, k, v, causal=True),
                      ref.ref_attention(q, k.repeat_interleave(g, 2),
                                        v.repeat_interleave(g, 2),
                                        causal=True))

    def kernel(q, k, v):
        return ops.flash_attention(q, k, v, causal=True)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    t_kernel = time_ms(torch, kernel, sets, iters)
    t_plain = time_ms(torch, lambda q, k, v: ref.ref_attention(
        q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2),
        causal=True), sets, max(4, iters // 4))
    t_lib = time_ms(torch, sdpa, sets, iters)
    d_kernel = device_ms(torch, kernel, sets, 20)
    d_lib = device_ms(torch, sdpa, sets, 20)
    flops = 4 * b * h * d * s * (s + 1) // 2     # row i sees i + 1 keys
    t_bound, by = bound(per_call, flops)
    print(f"  timing {shape}: kernel {t_kernel} ms (device {d_kernel} ms), "
          f"plain {t_plain} ms, sdpa {t_lib} ms (device {d_lib} ms), bound "
          f"{t_bound} ms ({by}: {per_call} B, {flops} FLOP)")
    return dict(shape=shape, max_abs_err=err, ms=t_kernel,
                device_ms=d_kernel, plain_ms=t_plain, bound_ms=t_bound,
                bound_by=by, library_ms=t_lib, library_device_ms=d_lib)


def decode_timing(torch, randn, b, t_cap, pos, iters, h=H, kh=KH, d=D):
    """K2 at one shape: checked against its plain version, then timed
    (kernel, plain, SDPA; host-timed and as a CUDA graph) beside its bound,
    the caches rotated past the L2 cache."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    # q read and the output written once; K and V cache rows 0..pos read
    per_call = (2 * b * h * d + 2 * b * (pos + 1) * kh * d) * 2
    sets = [(Q_SCALE * randn(b, h, d), randn(b, t_cap, kh, d),
             randn(b, t_cap, kh, d)) for _ in range(n_sets(per_call))]
    q, kc, vc = sets[0]
    shape = f"B={b} T={t_cap} H={h} K={kh} D={d} pos={pos}"
    err = check_close(torch, shape, ops.decode_attention(q, kc, vc, pos),
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
    flops = 4 * b * h * d * (pos + 1)
    t_bound, by = bound(per_call, flops)
    print(f"  timing {shape}: kernel {t_kernel} ms (device {d_kernel} ms), "
          f"plain {t_plain} ms, sdpa {t_lib} ms (device {d_lib} ms), bound "
          f"{t_bound} ms ({by}: {per_call} B, {flops} FLOP)")
    return dict(shape=shape, max_abs_err=err, ms=t_kernel, device_ms=d_kernel,
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
    one shorter than a chunk, then at zamba2's prefill shape (state 64):
    bf16 x, B and C as the model passes them."""
    gen = torch.Generator(device=dev).manual_seed(1)
    print("phase 3: K3 ssd chunk scan vs plain (bf16 x, B, C; f32 dt, A)")
    rec = ssd_timing(torch, gen, dev, SSM_H, SSM_N,
                     (("prefill", SSM_P), ("ragged", 300), ("short", 100)))
    rec.pop("shape")
    print("phase 3: K3 at zamba2's shape (112 heads, state 64)")
    zamba = ssd_timing(torch, gen, dev, HYB_SSM_H, HYB_SSM_N,
                       (("prefill", HYB_P),))
    return {"ssd": dict(
        name="ssd", route="cuda", source="src/repro_torch/kernels/csrc/ssd.cu",
        replaces="src/repro/kernels/ssd.py:87",
        max_abs_err=max(rec.pop("max_abs_err"), zamba["max_abs_err"]), **rec,
        zamba2=zamba)}


def ssd_timing(torch, gen, dev, h, n, cases):
    """K3 with ``h`` heads of width SSM_HD and state ``n``: checked against
    ref_ssd at each (label, sequence length) of ``cases``, then timed at
    the first one beside its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    b, p = B, SSM_HD

    def inputs(s):
        x = torch.randn((b, s, h, p), generator=gen, device=dev)
        dt = F.softplus(torch.randn((b, s, h), generator=gen, device=dev))
        A = -torch.exp(torch.randn((h,), generator=gen, device=dev))
        Bm = torch.randn((b, s, 1, n), generator=gen, device=dev)
        Cm = torch.randn((b, s, 1, n), generator=gen, device=dev)
        return (x.to(torch.bfloat16), dt, A, Bm.to(torch.bfloat16),
                Cm.to(torch.bfloat16))

    errs = []
    for label, s in cases:
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
            fail(f"ssd {label} at H={h} N={n} disagrees with its plain "
                 f"version")
        errs.append(y_err)
    s = cases[0][1]
    # x, dt, B, C (and A) read once; y and the f32 final state written once
    per_call = (2 * b * s * h * p * 2 + b * s * h * 4 + 2 * b * s * n * 2
                + h * 4 + b * h * p * n * 4)
    sets = [inputs(s) for _ in range(n_sets(per_call))]

    def kernel(*a):
        return ops.ssd(*a, chunk=SSM_CHUNK)

    t_kernel = time_ms(torch, kernel, sets, 20)
    t_plain = time_ms(torch, lambda *a: ref.ref_ssd(*a, chunk=SSM_CHUNK),
                      sets, 4)
    d_kernel = device_ms(torch, kernel, sets, 10)
    flops = ssd_flops(b, s, h, p, n, SSM_CHUNK)
    t_bound, by = bound(per_call, flops)
    shape = f"B={b} S={s} H={h} P={p} N={n} chunk={SSM_CHUNK}"
    print(f"  timing {shape}: kernel {t_kernel} ms (device {d_kernel} ms), "
          f"plain {t_plain} ms, no library call computes an SSD scan, bound "
          f"{t_bound} ms ({by}: {per_call} B, {flops} FLOP)")
    return dict(shape=shape, max_abs_err=max(errs), ms=t_kernel,
                device_ms=d_kernel, plain_ms=t_plain, bound_ms=t_bound,
                bound_by=by, library_ms=None, library_device_ms=None)


# ------------------------------------------------ phases 4, 6: serving

def profile_round(torch, run):
    """``run()`` once more (the resident job, no context switch) with the
    device traced: the card's busy share and its kernel time by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    torch.cuda.reset_peak_memory_stats(dev)
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
              f"allocated {torch.cuda.memory_allocated(dev)} B, peak through "
              f"the inits {torch.cuda.max_memory_allocated(dev)} B")
        torch.cuda.reset_peak_memory_stats(dev)
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
        print(f"  peak card memory over the rounds "
              f"{torch.cuda.max_memory_allocated(dev)} B; pinned host bytes "
              f"held {pinned_bytes(torch)}")
        profile_round(torch, lambda: deps["B"].generate(
            prompts[0], max_new_tokens=N_NEW,
            temperature=0.7).wait(timeout=600))
    switches = router.switch_log
    for s in switches:
        print(f"  switch to {s['to_job']}: offload {s['t_offload']} s "
              f"{s['offload_bytes']} B, load {s['t_load']} s "
              f"{s['load_bytes']} B")
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

def parity_phase(torch, model, params, dev, phase):
    """Prefill and teacher-forced decode logits on the card against the
    same parameters through the plain versions on the CPU."""
    from repro_torch.models import common
    from repro_torch.rl import data as data_lib
    from repro_torch.rl.rollout import _pad_cache

    cfg = model.cfg
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


# -------------------------------------------- phases 8, 9: training

def seeded_train_batch(forward, b, s, p_len, seed):
    """A packed GRPO batch (numpy) whose advantages are non-zero:
    MathDataset prompts, seeded completion tokens in the tokenizer's range,
    behavior logprobs the deployment's own (``forward``, the FORWARD op)
    within +-0.05, advantages from a normal."""
    import numpy as np
    from repro_torch.rl import data as data_lib

    rng = np.random.default_rng(seed)
    prompts = next(data_lib.MathDataset(seed=seed).batches(b, p_len))[0]
    comp = rng.integers(data_lib.EOS + 1, data_lib.VOCAB_MIN,
                        size=(b, s - p_len))
    mask = np.zeros((b, s), np.float32)
    mask[:, p_len:] = 1.0
    batch = {"tokens": np.concatenate([prompts, comp], 1).astype(np.int32),
             "behavior_logprobs": np.zeros((b, s), np.float32),
             "advantages": rng.standard_normal(b).astype(np.float32),
             "loss_mask": mask}
    lp = forward(batch).float().cpu().numpy()
    behave = np.zeros((b, s), np.float32)
    behave[:, 1:] = lp + rng.uniform(-0.05, 0.05, size=lp.shape)
    batch["behavior_logprobs"] = behave * mask
    return batch


def counted(wpg, job, log):
    """Wrap a WPG's ``execute`` to log each op's job, name, seconds (from
    its exec_log) and the kernel launches it made."""
    from repro_torch.kernels import ops

    execute = wpg.execute

    def run(qop):
        before = dict(ops.LAUNCHES)
        out = execute(qop)
        log.append((job, qop.op.value, wpg.exec_log[-1][1],
                    {k: ops.LAUNCHES[k] - before[k] for k in before}))
        return out

    wpg.execute = run


def train_phase(torch, dev, records):
    """Two GRPO jobs' steps through Router -> HRRS -> WPG at full width,
    then a seeded update and a profiled one."""
    from repro_torch.core.controller import (JobConfig, RLControllerGRPO,
                                             run_interleaved)
    from repro_torch.core.router import Router
    from repro_torch.kernels import ops
    from repro_torch.models import common

    n_new = TRAIN["max_new_tokens"]
    print(f"phase 8: GRPO training {ARCH} at full width and depth, jobs A "
          f"and B on group 0 ({TRAIN}, overrides {TRAIN_OVERRIDES}), steps "
          f"submitted round-robin and drained")
    router = Router()
    ctls = {job: RLControllerGRPO(JobConfig(
        job_id=job, model_name=ARCH, seed=seed, overrides=TRAIN_OVERRIDES,
        **TRAIN), router) for seed, job in enumerate("AB", start=1)}
    log = []
    for job, c in ctls.items():
        counted(c.dep.wpg, job, log)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    run_interleaved(router, list(ctls.values()))
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    layers = ctls["A"].dep.wpg.cfg.num_layers
    want = {"init": {"flash_attention": 0, "decode_attention": 0, "ssd": 0},
            "generate": {"flash_attention": layers,
                         "decode_attention": layers * n_new, "ssd": 0},
            "update_actor": {"flash_attention": layers,
                             "decode_attention": 0, "ssd": 0}}
    for job, op, sec, grew in log:
        print(f"  job {job} {op}: {sec} s, launches {grew}")
        if grew != want[op]:
            fail(f"job {job} {op}: launches {grew}, want {want[op]}")
    print(f"  {len(log)} ops in {wall} s; launches {launches}; peak card "
          f"memory {peak} B")
    sm = router.state_managers[0]
    nbytes = {job: sm.job_bytes(c.dep.wpg.job_prefix)
              for job, c in ctls.items()}
    for sw in router.switch_log:
        print(f"  switch to {sw['to_job']}: offload {sw['t_offload']} s "
              f"{sw['offload_bytes']} B, load {sw['t_load']} s "
              f"{sw['load_bytes']} B")
    moved = [sw for sw in router.switch_log if sw["t_offload"] > 0]
    if len(moved) < 3:
        fail(f"only {len(moved)} context switches offloaded a job")
    # both jobs are resident after their inits, so the first switch only
    # offloads; every later one moves both jobs' whole state
    for i, sw in enumerate(moved):
        other = "B" if sw["to_job"] == "A" else "A"
        load = (0, nbytes[sw["to_job"]]) if i == 0 else \
            (nbytes[sw["to_job"]],)
        if sw["offload_bytes"] != nbytes[other] or \
                sw["load_bytes"] not in load:
            fail(f"switch to {sw['to_job']} moved {sw['offload_bytes']} / "
                 f"{sw['load_bytes']} B, the jobs hold {nbytes}")
    for job, c in ctls.items():
        if len(c.metrics_log) != TRAIN["steps"]:
            fail(f"job {job}: {len(c.metrics_log)} steps recorded")
        for i, (m, r) in enumerate(zip(c.metrics_log, c.reward_log)):
            print(f"  job {job} step {i}: loss {m['loss']}, grad_norm "
                  f"{m['grad_norm']}, lr {m['lr']}, mean reward {r}")
            if not all(math.isfinite(v) for v in m.values()):
                fail(f"job {job} step {i}: non-finite metrics {m}")
    for k in ("flash_attention", "decode_attention"):
        records[k]["train_launches"] = dict(
            total=launches[k], per_generate=want["generate"][k],
            per_update_actor=want["update_actor"][k])

    # random weights earn no reward, so the steps above had zero
    # advantages: a seeded batch makes the gradient non-zero
    dep = ctls["A"].dep
    wpg = dep.wpg

    def done(fut):
        router.drain()
        return fut.result()

    batch = seeded_train_batch(lambda b: done(dep.forward(b)),
                               TRAIN["batch_size"], TRAIN["seq_len"],
                               TRAIN["prompt_len"], 3)
    keys = sm.keys_for(wpg.job_prefix)
    ptrs = {k: sm.entries[k].ref.data_ptr() for k in keys}

    def mu_sums():
        return {k: v.abs().sum().item() for k, v in
                common.canonical_flat(wpg.opt_state().mu).items()}

    mu0 = mu_sums()
    m = done(dep.update_actor(batch))
    mu1 = mu_sums()
    print(f"  seeded update_actor (job A, B={TRAIN['batch_size']} "
          f"S={TRAIN['seq_len']}): {wpg.exec_log[-1][1]} s, loss "
          f"{m['loss']}, pg_loss {m['pg_loss']}, kl {m['kl']}, grad_norm "
          f"{m['grad_norm']}, lr {m['lr']}")
    still = [k for k in mu1 if mu1[k] == mu0[k]]
    print(f"  f32 first moments changed in {len(mu1) - len(still)} of "
          f"{len(mu1)} leaves (unchanged: {still})")
    if not m["grad_norm"] > 0 or len(still) > 1 or (
            still and still != ["layers/attn/bk"]):
        fail("the seeded update did not move the moments")
    if sm.keys_for(wpg.job_prefix) != keys or any(
            sm.entries[k].ref.data_ptr() != p for k, p in ptrs.items()):
        fail("the update replaced the job's tensors")
    print(f"  {len(keys)} entries kept their tensors across the update")
    profile_round(torch, lambda: done(dep.update_actor(batch)))
    return router


def train_parity_phase(torch, dev):
    """One update_actor on the card and on the CPU's plain path from the
    same parameters and batch, then K1's Function against autograd
    through the XLA-branch attention at the training shape."""
    from repro_torch.core import api
    from repro_torch.core.state_manager import StateManager
    from repro_torch.core.worker import WorkerProcessGroup
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import xla_attention
    from repro_torch.launch.mesh import MeshSlice
    from repro_torch.models import common
    from repro_torch.train.optimizer import AdamWConfig

    print(f"phase 9: training parity card vs CPU plain, {ARCH} at full "
          f"width cut to {PARITY_LAYERS} layers (depth only), B={PARITY_B} "
          f"S={PARITY_S}, AdamW {TRAIN_LR}, tied embedding scaled by 1/64")
    spec = api.DeploymentSpec(
        deployment_id="parity-train", job_id="P", model_name=ARCH,
        role="train", overrides=(("num_layers", PARITY_LAYERS),)
        + TRAIN_OVERRIDES)
    adamw = AdamWConfig(**TRAIN_LR)
    card = WorkerProcessGroup(spec, StateManager(
        mesh_slice=MeshSlice(0, dev)), adamw_cfg=adamw)
    cpu = WorkerProcessGroup(spec, StateManager(), adamw_cfg=adamw)
    # the seeded init's unit-scale tied embedding gives logits near 1e3
    # (a one-hot policy, mean token logprob about -800), where one bf16
    # step of a logit is 4 nats and the two sides' logprobs, ratios and kl
    # part by that much; scaled by 1/64 (exact in bf16) the policy is
    # spread and a bf16 step of a logit is a few hundredths
    params = card.model.init_params(
        torch.Generator(device=dev).manual_seed(3), dev)
    params["embed"]["embedding"].mul_(1 / 64)
    for w in (card, cpu):
        w.execute(api.make_op(spec, api.Op.INIT, params=params))
    del params
    batch = seeded_train_batch(
        lambda b: card.execute(api.make_op(spec, api.Op.FORWARD, b)),
        PARITY_B, PARITY_S, PARITY_S // 2, 4)
    out = {}
    for where, w in (("card", card), ("cpu", cpu)):
        out[where] = w.execute(api.make_op(spec, api.Op.UPDATE_ACTOR, batch))
        print(f"  {where} update_actor: {w.exec_log[-1][1]} s; {out[where]}")
    worst = 0.0
    for k in ("loss", "pg_loss", "kl", "grad_norm"):
        got, want = out["card"][k], out["cpu"][k]
        tol = 5e-2 * (want if k == "grad_norm" else max(1.0, abs(want)))
        worst = max(worst, abs(got - want) / tol)
        print(f"  {k}: card {got}, cpu {want}, |diff| {abs(got - want)}, "
              f"tolerance {tol}")
        if not abs(got - want) <= tol:
            fail(f"training parity {k}: {got} vs {want}")
    if not out["cpu"]["grad_norm"] > 0:
        fail("training parity: zero gradient")
    mu = {w: common.canonical_flat(x.opt_state().mu)
          for w, x in (("card", card), ("cpu", cpu))}
    for k, want in mu["cpu"].items():
        err = (mu["card"][k].cpu() - want).abs().max().item()
        tol = 5e-2 * want.abs().max().item()
        worst = max(worst, err / tol if tol else 0.0)
        if not err <= tol:
            fail(f"training parity: mu {k} max|diff| {err} > {tol}")
    print(f"  f32 mu of {len(mu['cpu'])} leaves within 5e-2 * max|mu| "
          f"(worst |diff| / tolerance over all checks {worst})")

    gen = torch.Generator(device=dev).manual_seed(5)
    b, s, h, kh = TRAIN["batch_size"], TRAIN["seq_len"], H, KH

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q, k, v, ct = randn(b, s, h, D), randn(b, s, kh, D), randn(b, s, kh, D), \
        randn(b, s, h, D)
    grads = {}
    for name, fn in (("function", ops.flash_attention),
                     ("xla", xla_attention)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = ops.LAUNCHES["flash_attention"]
        fn(*leaves, causal=True).backward(ct)
        torch.cuda.synchronize()
        grew = ops.LAUNCHES["flash_attention"] - before
        if grew != (1 if name == "function" else 0):
            fail(f"{name} attention launched K1 {grew} times")
        grads[name] = [t.grad.float() for t in leaves]
    for name, got, want in zip("qkv", grads["function"], grads["xla"]):
        err = (got - want).abs().max().item()
        tol = 5e-2 * want.abs().max().item()
        print(f"  d{name} B={b} S={s} H={h} K={kh} D={D}: max|diff| {err}, "
              f"tolerance {tol}")
        if not err <= tol:
            fail(f"K1's Function d{name} disagrees with the XLA branch")
    print("  K1 launched once by the Function's forward, none by its "
          "backward")


def path_launches(records, launches, want, path=None):
    """Write the path's launch counts into the records (into each kernel's
    ``path`` row where one is named); fail where a kernel of the path was
    never launched."""
    for name, per_round in want.items():
        if per_round == 0:
            continue
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on its serving path")
        (records[name][path] if path else records[name])["launches"] = \
            launches[name]


def release(torch, dev, what):
    """After ``what`` has been dropped: collect it, return the card's
    cached blocks and the pinned host blocks the caching host allocator
    keeps, and print what is still held of either."""
    gc.collect()
    torch.cuda.empty_cache()
    for name in ("_accelerator_emptyHostCache", "_host_emptyCache"):
        if hasattr(torch._C, name):
            getattr(torch._C, name)()
            break
    print(f"  {what} released: card memory allocated "
          f"{torch.cuda.memory_allocated(dev)} B; pinned host bytes held "
          f"{pinned_bytes(torch)}")


def pinned_bytes(torch):
    """Bytes of pinned host memory the caching host allocator owns (its
    blocks are powers of two), as this torch reports them."""
    stats = getattr(torch.cuda.memory, "host_memory_stats", None)
    held = stats().get("allocated_bytes.current") if stats else None
    return "not reported by this torch" if held is None else held


def hybrid_parity_phase(torch, dev, phase):
    """Phase 5's parity for zamba2 at full width, cut to HYB_PARITY_LAYERS
    blocks (depth only) for the CPU side, from the port's seeded init."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    model = build_model(get_config(HYB_ARCH).replace(
        num_layers=HYB_PARITY_LAYERS))
    params = model.init_params(torch.Generator(device=dev).manual_seed(1),
                               dev)
    return parity_phase(torch, model, params, dev, phase)


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
    cluster_report()
    records = kernel_phase(torch, dev)
    records.update(ssd_kernel_phase(torch, dev))

    want = {"flash_attention": LAYERS, "decode_attention": LAYERS * N_NEW,
            "ssd": 0}
    router, launches = serve_phase(torch, dev, 4, ARCH, P, want)
    path_launches(records, launches, want)
    wpg = router.wpgs["rollout-A"]
    parity_phase(torch, wpg.model, wpg.params(), dev, 5)
    # release the qwen2 deployments (device and pinned host memory)
    del router, wpg
    release(torch, dev, "qwen2 router")

    want = {"flash_attention": 0, "decode_attention": 0, "ssd": SSM_LAYERS}
    router, launches = serve_phase(torch, dev, 6, SSM_ARCH, SSM_P, want)
    path_launches(records, launches, want)
    wpg = router.wpgs["rollout-A"]
    parity_phase(torch, wpg.model, wpg.params(), dev, 7)
    del router, wpg
    release(torch, dev, "mamba2 router")

    router = train_phase(torch, dev, records)
    del router
    release(torch, dev, "training router")
    train_parity_phase(torch, dev)
    release(torch, dev, "training parity WPGs")

    # zamba2: all three kernels on one path, at full width and depth
    want = {"flash_attention": HYB_APPS, "decode_attention": HYB_APPS * N_NEW,
            "ssd": HYB_MAMBA}
    router, launches = serve_phase(torch, dev, 10, HYB_ARCH, HYB_P, want)
    path_launches(records, launches, want, "zamba2")
    del router
    release(torch, dev, "zamba2 router")
    hybrid_parity_phase(torch, dev, 11)
    print(f"all phases passed in {time.monotonic() - t_start} s")
    print(card)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
