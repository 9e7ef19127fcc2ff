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
   dim (16, 32, 64, 112, 128) for 1 split and for the most, and fail at
   0;
3. each kernel against its plain PyTorch version on the card, at the
   serving paths' shapes, with timings (kernel, plain version, one library
   call as a yardstick where one exists, and the card's least time for the
   same work): K1 and K2 at qwen2-0.5b's, K2 also at two long caches
   (B=16 T=4096 and the single straggler B=1 T=8192, under the record's
   ``long_context``), K3 at mamba2-2.7b's and at a ragged and a short
   sequence; then K1, K2 and K3 at zamba2-7b's shapes (under each record's
   ``zamba2``: head_dim 112, MHA; state 64) and K1 and K2 at the MoE
   paths' shapes (``qwen3_moe``: head_dim 128, GQA 32:4; granite's
   head_dim 64, GQA 24:8 under ``granite_prefill``, ``granite_training``
   and ``granite``) and at gemma2-27b's (GQA 32:16, head_dim 128, softcap
   50, scale 1/12: K1 at B=16 S=128 with and without the 4096-key window
   and at B=1 S=4352, where it cuts; K2 at the last step of both rounds;
   then K2's window of 100 starting mid-chunk and mid-split) and at
   whisper-large-v3's (MHA 20:20, head_dim 64: K1 non-causal at the
   encoder's S = T = 1500 and the cross-attention prefill's S = 128 over T =
   1500, K1 causal at the decoder's self-attention prefill, S = T = 128,
   K2 over the 1500 cross keys and at the self-attention's last step)
   and at llama-3.2-vision-90b's (GQA 64:8, head_dim 128: K1 causal at
   the self-attention prefill, S = T = 128, and non-causal at the
   cross-attention prefill, S = 128 over the T = 1601 patch keys; K2 over
   the 1601 cross keys and at the self-attention's last step), and at
   the examples' head widths (16 built, 12 padded to 16, each at an
   example's shapes; 12, 16 and 32 also checked with a window, non-causal
   over a ragged T, and K2 over a 16-split cache),
   K1's and K2's queries at 3x unit scale (``Q_SCALE``); the bounds
   count only the keys inside a window (a non-causal row all T), and the
   library call where SDPA takes no softcap is ``flex_attention``
   compiled. ``ms`` times back-to-back
   calls from Python (the wrapper's host cost included); ``device_ms`` and
   ``library_device_ms`` time a CUDA graph of the same calls, the card's
   own time;
4. the serving path at full qwen2-0.5b width: a Router with two jobs'
   deployments on node group 0, four alternating batched ``generate``
   calls, each with the kernels' launch counts set to 0 before and read
   after, then one more ``generate`` under the profiler (the ten largest
   device entries and every kernel of the port); each job holds its
   specs' bytes, every leaf is bit-exact (digests on the card) after each
   round the job runs, and a context switch moves the whole job or
   nothing each way;
5. whole-path parity for qwen2-0.5b: prefill and teacher-forced decode
   logits on the card against the same parameters through the plain
   versions on the CPU;
6. the serving path at full mamba2-2.7b width, its depth cut to 8 of 64
   layers, as phase 4, on a new Router once the qwen2 one is released;
7. whole-path parity for mamba2-2.7b, as phase 5, at full width cut to
   16 of its 64 layers;
8. the GRPO training path at full qwen2-0.5b width and depth, on a new
   ``PlexCluster`` once the mamba2 router is released: jobs A and B
   (``RLControllerGRPO``) on group 0, two steps each (generate -> pack ->
   update_actor), through ``PlexCluster.run(interleave=True)``, with each
   op's seconds and kernel launches, every context switch's seconds and
   bytes (parameters and f32 AdamW moments), each job's bill (every
   submitted op billed), the steps' metrics and the peak card memory.
   The training forward rematerialises each layer group (``cfg.remat``
   "full", every config's default), so an op with a gradient
   (``update_actor``, PPO's ``forward_backward``) launches K1 and K3 twice
   a layer, here and in phases 12–14, 16, 18 and 21;
   then one ``update_actor`` on a seeded batch with non-zero advantages
   (the gradient is non-zero, the moments change, the job's tensors are
   updated in place) and one more under the profiler;
9. training parity: one ``update_actor`` on the card against the same
   one on the CPU's plain path, at full width, 4 layers and B=2 (the tied
   embedding scaled by 1/64, so the random policy is not one-hot), and
   K1's autograd Function against plain autograd through the XLA-branch
   attention at the training shape;
10. the serving path at full zamba2-7b width, its depth cut to 8 of 81
    blocks (K3 in each of the 7 Mamba2 blocks' prefill, K1 in the one
    application of the shared attention block, K2 in each
    application's decode), as phase 6, once every earlier router and the
    pinned host buffers they held are released;
11. whole-path parity for zamba2-7b, as phase 5, at full width cut to 15
    blocks (2 applications, 1 trailing block) for the CPU side;
12. the training entry point: ``python -m repro_torch.launch.train`` at
    full qwen2-0.5b width, 2 of its 24 layers (two jobs, two steps each), in a child
    process on its default device, the card, with the kernels' launch
    counts set to 0 before it and printed after, and ``--ckpt-dir`` under a
    temporary directory: what it wrote after the run is listed;
13. the control plane live on the card: a serving ``PlexCluster`` whose
    ``PlacementDirector`` cold-places two full-width training jobs on
    their own groups, re-fits them onto one group (migrating one live:
    its f32 leaves bit-exact across the move, no copy on one card),
    retires the profiling group and spawns one for a third job; every job
    completes, its bill equals its exec logs, and ``remove_job`` returns
    the third job's bytes to the card;
14. phase 8 for mamba2-2.7b at full width, its depth cut to 8 of 64
    layers (K3 under its autograd Function in every update_actor's
    forward: 8 launches a generate and 16 an update under remat, none of
    K1 or K2), once the host's ``MemTotal`` and ``MemAvailable`` are
    printed and shown to hold both jobs' pinned train state (which every
    switch moves);
15. training parity for the ssm and hybrid families: one update_actor on
    the card against the CPU's plain path at B=2, mamba2-2.7b at 2 layers
    and zamba2-7b at 8 blocks over 32 tokens (one application of the
    shared block between Mamba2 blocks), full width, the CPU side without
    remat; then
    K3's Function against plain autograd
    through ``ssd_chunked`` at the training shape (B=16 S=128 H=80 P=64
    N=128) and K3's timing there (the record's ``training`` row);
16. PPO: a PPO job (actor and critic) and a GRPO job of qwen2-0.5b at full
    width cut to 6 of 24 layers on group 0, two steps each, through ``PlexCluster.run``, with
    launch counts, both bills and the critic's divergence from the actor
    after SYNC_WEIGHTS and a value step; a seeded PPO actor step with
    token-level advantages (a non-zero gradient that moves the moments);
    then ``OPTIM_STEP(host=True)`` at lr 1e-2 against the device AdamW (no
    clip, warmup or weight decay): every parameter leaf moves, the host
    parameters agree within 2e-3 and the card-resident moments within a
    relative 1e-5;
17. checkpoints and the DISK tier: a full-width qwen2-0.5b training job's
    state to DISK and back, one ``host_capacity`` eviction to DISK, then
    ``checkpoint_all`` -> ``fail_node`` -> ``restore_all``, each bit-exact
    on the card; the temporary files are removed at the end;
18. the process plane: phase 8's two jobs, cut to 4 of the 24 layers,
    on two groups through
    ``PlexCluster.run(concurrent=True)``, first in thread mode (one step
    each, exact launches and bills), then (one step each) with
    each group's WPGs in a spawned child process on the same card
    (``process_plane=True``): every op runs in its group's child, with
    exact K1 and K2 launches read there, every op billed, both wall times
    and a child's CUDA-context memory printed; then a bit-exact
    cross-child SYNC_WEIGHTS, job B's train state moved live to the other
    child over /dev/shm and back through the disk-spill
    route (bit-exact each way), and group 1's child killed with SIGKILL
    mid-generate: the op fails naming the group, its dependent is
    poisoned, the card memory comes back, the ops done before stay
    billed, the respawn leaves no segment or spill file, and the job
    restores the checkpoint it saved through the op path and takes one
    more step; ``close_processes`` leaves no child and no segment;
19. the MoE serving path: one Qwen3-30B-A3B job at full width, its
    depth cut to 12 of 48 layers, through Router -> WPG -> rollout, INIT
    then two generates (B=16, prompt 256, 64 new, the last under the
    profiler), each with exactly 12 K1 and 768 K2 launches and a peak
    under 80 GB, the prefill's capacity drops counted;
20. whole-path parity for Qwen3-30B-A3B at full width cut to 2 layers,
    as phase 5 at B=16, with the routing recorded on both sides: every
    flip must be a near-tie of the router's logits, the flips few, and
    the logits are held where the routing agreed;
21. phase 8 for granite-moe-3b-a800m at full width, its depth cut to 8
    of 32 layers, once the host is shown to hold both jobs' pinned train
    state (which every switch moves, the f32 router and moments bit-exact
    across it): exactly 96 K1 and 2,048 K2 launches over the four steps,
    every op billed, and the seeded update moves the router and expert
    leaves in place;
22. training parity for granite at full width, 4 layers and B=2, as phase 9,
    the MoE aux loss included;
23. the gemma2 serving path: one gemma2-27b job at full width, its depth
    cut to 12 of 46 layers (6 local/global pairs), through Router -> WPG
    -> rollout, INIT then two generates at B=16 prompt 128 (the last
    under the profiler) and one at B=1 prompt 4352, where the local
    layers' 4096-key window cuts in K1's prefill and in every K2 step;
    each with exactly 12 K1 and 768 K2 launches and a peak under 80 GB;
24. whole-path parity for gemma2-27b at full width cut to 2 layers (one
    local, one global), as phase 5 at B=2 prompt 128, then at B=1 prompt
    4352: on the CPU where the first check's CPU side predicts it within
    two minutes, else against the card with ``kernels/ref.py``'s attention
    in place of K1 and K2; the logits are held before the final softcap,
    where they are a bf16 product, as phase 5 holds every other model's;
25. the audio serving path, as phase 4: two whisper-large-v3 jobs at
    full width, their depth cut to 8 of 32 encoder and 8 of 32 decoder
    layers, each ``generate`` given bf16 frames (B=16, 1500, 1280) through
    ``extra_inputs`` (B=16, prompt 128, 64 new): each with exactly 24 K1
    (encoder, decoder self- and cross-attention prefill) and 1,024 K2
    (self- and cross-attention decode) launches and a peak under 80 GB;
26. whole-path parity for whisper-large-v3 at full width cut to 2
    encoder and 2 decoder layers, as phase 5 over frames at the real
    encoder_seq of 1500, the bound counting both stacks' layers;
27. the vlm serving path, as phase 4 with one job: llama-3.2-vision-90b
    at full width, its depth cut to 10 of 100 layers (2 groups of 4
    self-attention layers and a gated cross-attention layer), both gates of every cross layer written
    to 1.0 after INIT through ``StateManager.write`` (zero at init, they
    hide the cross path), then three generates (B=16, prompt 128 of seeded
    ids, 64 new, the last under the profiler), each given its own bf16
    patch embeddings (16, 1601, 8192) at the reference's ``dummy_batch``
    scale through ``extra_inputs``: each with exactly 10 K1 (8 self, 2
    cross prefill) and 640 K2 (512 self, 128 cross decode) launches
    and a peak under 80 GB;
28. whole-path parity for llama-3.2-vision-90b at full width cut to one
    group (4 self layers and the cross layer, gates 1.0), as phase 5 but
    with 4 teacher-forced decode steps, over
    unit-scale patch embeddings at the real vision_seq of 1601 (each
    row's sharing a component), after a check on the card that the cross
    path moves the logits;
29. the cost model on the card: qwen2-0.5b's prefill (B=16 S=128), one
    decode step (T=192, pos=191) and one ``update_actor`` at phase 8's
    packed batch, at full width and depth, and mamba2-2.7b's prefill
    (B=16 S=512, phase 6's K3) at full width cut to 4 layers, each
    through ``launch/hlo_cost`` once on the card and once on ``meta``
    tensors: their FLOPs, bytes, ops and per-kernel launches and work
    equal exactly, each kernel's counted launches equal the change in
    ``LAUNCHES``, K1's, K2's and K3's work a launch is PERF.md's bound
    column; each step's peak of live bytes tracked on ``meta`` (the dry
    run's temporaries and the outputs the step makes) within 10 % + 64 MiB
    of the card's ``max_memory_allocated()`` above what was allocated
    before it; then each step under the profiler, its counted FLOPs over
    the device busy time printed as a share of the 989 TFLOP/s bf16 peak;
30. the port's examples on the card at the reference's head widths
    (quickstart 16, multiplex_rlvr 12): ``quickstart`` whole,
    ``cluster_sim``, ``multiplex_rlvr``'s Parts 1-2 through its
    ``run(...)``, its Parts 3-6 (Part 6's SLO trigger preempting or
    holding the best-effort job, then admitting the queued one) and
    ``train_100m --steps 2`` in a child process, each with its seconds
    and launch counts;
31. multi-token cache writes: K1 with a query offset over the first
    cache_pos + s rows of a cache read in place, against its plain
    version and timed (SDPA with a boolean mask, or compiled
    ``flex_attention`` for gemma2's window and softcap, as the library
    yardstick) at qwen2-0.5b's (GQA 14:2, D=64), gemma2-27b's (32:16,
    D=128, softcap 50, scale 1/12, cache_pos 4,120 where the 4,096-key
    window cuts) and zamba2-7b's (MHA 32:32, D=112) heads, s = 2, 16 and
    128 (timed at 2 and 128); then ``attn_apply`` with s new tokens on the card, one K1 launch
    each, against the same full-width layer on the CPU;
32. node groups of several devices: the one card seen as four virtual
    devices (``DevicePlane(devices=[cuda:0] * 4, slice_size=2)``), two
    qwen2-0.5b GRPO jobs at full width cut to 6 of 24 layers, one on
    each 2-device group, one step each through ``PlexCluster.run`` (B=16,
    prompt 128, 64 new), tensor-parallel: K1 and K2 on each device at its
    7 local query heads and 1 KV head (exactly 12 K1 and 12 x 64 K2 a
    generate, 24 K1 an update_actor), every op billed; K1 and K2 checked
    and timed at those per-device shapes; prefill and decode logits of the
    seeded model at full depth over 2 and over 4 devices (the
    head-dim-parallel decode) against the same parameters on one device;
    job A migrated live to the other slice (``cross_mesh`` True, every
    leaf bit-exact) and synced into a rollout deployment on the first
    slice (bit-exact); one generate on a 4-device slice at 6 layers (24
    K1, no K2: the head-dim-parallel decode); each sub-step's seconds and
    the card's peak;
33. the MoE family over a slice (expert parallelism), the card again seen
    as virtual devices: Qwen3-30B-A3B at full width cut to 12 of 48
    layers served as one job on a 2-device group (16 query heads, 2 KV
    heads and 64 of the 128 experts a device: exactly 24 K1 and 1,536 K2
    a generate) and, cut to 6 layers, once on a 4-device group (24 K1,
    1,536 K2); logits of
    2 layers over 2 and 4 devices against one device, which replays the
    slice's expert ids (the flips near-ties, at most 0.25 %); two granite
    GRPO jobs at full width cut to 8 of 32 layers on two 2-device groups
    (20 experts a device; the 49,155-row vocabulary does not split, so
    the tied embedding is replicated), two steps each, billed, every
    entry on its slice, then job A migrated live to the other slice,
    bit-exact; granite's update_actor on a slice against one device; K1
    and K2 at the per-device shapes against their plain versions and
    timed;
34. mamba2 and zamba2 over a slice (SSD heads split): mamba2-2.7b at full
    width cut to 16 of 64 layers served on a 2-device group (K3 at 40
    heads a device: exactly 32 K3 a generate) and, cut to 8 layers, on a
    4-device group (32 K3); one mamba2 GRPO job on a 2-device group at
    phase 14's shapes (8 layers: 16 K3 a generate, 32 an update_actor);
    logits over 2 and 4 devices against one; update_actor on a slice
    against one device; zamba2-7b at full width cut to 15 of 81 blocks
    served on a 2-device group (the shared block at 16 heads a device:
    exactly 4 K1, 256 K2 and 26 K3); K3 at 40 and 56 heads and K1 and K2
    at zamba2's 16 heads a device against their plain versions and timed;
35. gemma2, whisper and the vlm family over a slice: gemma2-27b at full
    width cut to 8 of 46 layers on a 2-device group (16 query and 8 KV
    heads a device, the window and both softcaps; B=16 prompt 128, then
    B=1 prompt 4,352 where the window cuts) and, cut to 4 layers, once on
    a 4-device group (8:4 heads); two whisper-large-v3 jobs at 8 + 8 of 32 + 32 layers on
    two 2-device groups (10 heads a device: the encoder, the cross prefill
    and the cross decode at local heads; the frames through
    ``extra_inputs``), job A migrated live to the other slice and
    generating there, one generate on a 4-device group at 4 + 4 layers (5
    heads, the vocabulary replicated); llama-3.2-vision-90b at 10 of 100
    layers on a 4-device group (16:2 heads a device, the gates written to
    1.0 after INIT, one generate given its patch embeddings through
    ``extra_inputs``); each
    generate's launches exactly n times the one-device path's; logits
    over 2 and 4 devices against one for each family; update_actor on a
    slice against one device for gemma2 and whisper; K1 and K2 at the new
    per-device shapes against their plain versions and timed;
36. process-mode groups of several devices: the card as 4 virtual devices
    carved into two 2-device slices, each group in its own spawned child
    that sees its slice (``PlexCluster(n_groups=2, devices_per_group=2,
    process_plane=True)``): two qwen2-0.5b GRPO jobs at full width cut to
    4 of 24 layers, one step each at phase 8's shapes through
    ``run(interleave=True, concurrent=True)``, each op's K1 and K2
    launches read in its child exactly twice the one-device path's (7
    query heads and 1 KV head a device), none in the parent, every op
    billed, every entry on its slice; K1 and K2 at those per-device
    shapes (B=16: the prefill at S=T=64, the training forward at S=T=128,
    the decode's last step at T=128) against their plain versions and
    timed, each row with the children's launches at its shape; a greedy
    generate and the FORWARD of
    its tokens in a child at 2 layers, B=2 prompt 64, against thread mode
    on the same slice (tokens equal, logprobs within phase 5's bound); job
    A moved live into the other child (``cross_mesh`` True, every entry's
    gathered bits as before, in the target slice's layout; its seconds,
    bytes and route) and generating there; a cross-process SYNC_WEIGHTS
    into target shardings, bit-exact in the target child; a PPO job
    (actor and critic) on a 2-device group, one step, its gradients
    across the pipe; ``OPTIM_STEP(host=True)`` over the slice in the child
    and in thread mode against one device's host step on the same gathered
    gradients (rtol 2^-7 bf16, 1e-5 f32), replicas alike, then a prefetch
    and a generate; the children's CUDA contexts released at the end.

Each phase prints its seconds, and its start to the standard error. The
earlier paths' depth is cut where a phase's time would otherwise crowd the
run's 1,200 s: every kernel is still checked against its plain version at
the paths' shapes and every path's launches are still counted.

The line before the last is the kernels' JSON record; the last line is the
device record ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the repository's ``src/`` beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import glob
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

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
# heads of width 64, state 128, chunk 256, 64 layers. Phase 6 serves it at
# full width cut to 8 of them, phase 14 trains it cut to 8
SSM_ARCH = "mamba2-2.7b"
SSM_P = 512
SSM_H, SSM_HD, SSM_N, SSM_CHUNK = 80, 64, 128, 256
SSM_LAYERS = 8              # phase 6's depth, an eighth of the model's
SSM_PARITY_LAYERS = 16      # phase 7's depth
SSM_TRAIN_LAYERS = 8        # phase 14's depth, an eighth of the model's

# the zamba2 serving path's shapes (batch 16, prompt 512, 64 new): 81 blocks,
# 11 applications of the shared attention block (32 heads of width 112,
# MHA) and 70 Mamba2 blocks (112 SSD heads of width 64, state 64, chunk 256).
# Phase 10 serves it at full width cut to 8 blocks (1 application, 7
# Mamba2 blocks, 1 of them trailing); its parity phase at 15 (2
# applications, 13 Mamba2 blocks, 1 trailing)
HYB_ARCH = "zamba2-7b"
HYB_P = 512
HYB_H, HYB_D = 32, 112
HYB_SSM_H, HYB_SSM_N = 112, 64
HYB_LAYERS = 8
HYB_PARITY_LAYERS = 15


# the MoE serving path (phase 19): Qwen3-30B-A3B at full width, its depth
# cut to 12 of 48 layers, one job (batch 16, prompt 256, 64 new): 32 query
# heads and 4 KV heads of width 128, 128 experts top-8; its parity phase
# (20) cuts depth to 2 layers
MOE_ARCH = "paper-qwen3-30b-a3b"
MOE_P = 256
MOE_H, MOE_KH, MOE_D = 32, 4, 128
MOE_LAYERS = 12
MOE_ROUNDS = 2
MOE_PARITY_LAYERS = 2
MOE_PARITY_B = 16
# routing flips card vs CPU, of all choices; every flip must also be a
# near-tie of the router's logits. At these inputs the card's router logits
# differ from the CPU's by up to 4e-3, and 38 of the 18,432 choices (0.21 %)
# flip, each at a k-th to (k+1)-th gap within twice that difference
# (PERF.md)
MOE_FLIP_SHARE = 2.5e-3
# the MoE training path (phase 21): phase 8's two GRPO jobs of granite at
# full width (24 query heads and 8 KV heads of width 64, 40 experts top-8),
# its depth cut to 8 of 32 layers; its parity phase (22) cuts depth to 4
# layers
GRANITE_ARCH = "granite-moe-3b-a800m"
GRANITE_H, GRANITE_KH, GRANITE_D = 24, 8, 64
GRANITE_LAYERS = 8

# the gemma2 serving path (phase 23): gemma2-27b at full width, its depth
# cut to 12 of 46 layers, one job: pairs of a local layer (a 4096-key
# window) and a global one, 32 query heads and 16 KV heads of width 128, the attention
# softcap 50 and scale (4608 / 32)^-1/2 = 1/12; rounds at B=16 prompt 128,
# then one at B=1 prompt 4352 (T = 4416), where the window cuts in K1's
# prefill and in every K2 step. Its parity phase (24) cuts depth to one
# pair, at B=2 prompt 128, and once more at B=1 prompt 4352
GEMMA_ARCH = "gemma2-27b"
GEMMA_H, GEMMA_KH, GEMMA_D = 32, 16, 128
GEMMA_LAYERS = 12
GEMMA_WINDOW, GEMMA_CAP, GEMMA_SCALE = 4096, 50.0, 1 / 12
GEMMA_P, GEMMA_ROUNDS, GEMMA_LONG_P = 128, 2, 4352
GEMMA_PARITY_LAYERS, GEMMA_PARITY_B = 2, 2
# phase 24's long check runs on the CPU when the B=2 check's CPU side,
# scaled by the tokens (4352 / 512), predicts at most this many seconds;
# else against the card's plain attention
GEMMA_CPU_LONG_S = 120.0

# the whisper serving path (phase 25): whisper-large-v3 at full width, its
# depth cut to 8 of its 32 encoder layers (over 1,500 frames) and 8 of its
# 32 decoder layers, two jobs on one group: 20 heads of width 64 (MHA),
# prompt 128, 64 new; 24 K1 (8 each of the encoder, the decoder's
# self-attention and its cross-attention prefill) and 2 x 8 x 64 K2 (self
# and cross) a generate. The full model holds 3,070,438,400 B of bf16
# parameters; a switch moves the cut one's. Its parity phase (26) cuts
# depth to 2 encoder and 2 decoder layers
WHISPER_ARCH = "whisper-large-v3"
WHISPER_H, WHISPER_D, WHISPER_T = 20, 64, 1500
WHISPER_LAYERS, WHISPER_P = 8, 128
WHISPER_BYTES = 3_070_438_400
WHISPER_FRAME_SCALE = 0.02      # the reference's dummy_batch
WHISPER_PARITY_LAYERS = 2

# the vlm serving path (phase 27): llama-3.2-vision-90b at full width, its
# depth cut to 10 of 100 layers (a multiple of the cross_attn_period of 5;
# the full model's parameters would not fit the 80 GB), one job: 2 groups
# of 4 self layers and a gated cross layer, 64 query heads and 8 KV heads
# of width 128, the cross layers over 1,601 patch embeddings; prompt 128,
# 64 new; 10 K1 and 10 x 64 K2 a generate. Its parity phase (28) cuts
# depth to one group
VISION_ARCH = "llama-3.2-vision-90b"
VISION_H, VISION_KH, VISION_D, VISION_T = 64, 8, 128, 1601
VISION_LAYERS, VISION_PERIOD, VISION_P = 10, 5, 128
VISION_SCALE = 0.02             # the reference's dummy_batch
VISION_GATE = 1.0

# the examples' head widths (phase 3): quickstart's 16 (built) at its
# update_actor (B=8 S=32) and last decode step (B=4 T=16), multiplex_rlvr's
# 12 (padded to 16) at its generate's prefill (B=8 S=12) and last decode
# step (B=8 T=18), 4 query and 2 KV heads; 32 (built) checked only; K2 also
# over one long cache (B=1 T=4096: 16 splits, more than D / 4, so each row's
# m and l go to several blocks of the cluster)
EX_H, EX_KH = 4, 2
EX_LONG_T = 4096

# phase 31: multi-token cache writes through K1 with a query offset, at
# full width: (label, arch, B, cache_pos, attention options); cache_pos sits
# mid-tile (not a multiple of K1's 32-key chunks or 64-row q-tiles), and
# gemma2's at its long round, where the 4096-key window cuts
OFFSET_CASES = (
    ("qwen2", "qwen2-0.5b", B, 150, {}),
    ("gemma2", "gemma2-27b", 1, 4120,
     dict(window=GEMMA_WINDOW, softcap=GEMMA_CAP, scale=GEMMA_SCALE)),
    ("zamba2", "zamba2-7b", B, 550, {}),
)
OFFSET_S = (2, 16, 128)
OFFSET_TIMED = (2, 128)     # the s whose K1 calls are timed

# the training path (phase 8): two GRPO jobs, as JobConfig fields, at the
# full config (TRAIN_OVERRIDES empty); phase 9's parity cuts depth only
TRAIN = dict(batch_size=16, group_size=4, prompt_len=64, max_new_tokens=64,
             seq_len=128, steps=2)
TRAIN_OVERRIDES = ()
PPO_LAYERS = 6              # phase 16's jobs, a quarter of qwen2-0.5b's depth
# phase 18's jobs: phase 8's at full width, cut to 4 of the 24 layers (a
# generate still lasts long enough to be caught and killed mid-way),
# PROC_STEPS steps each in process mode; cut from 6 layers and 2 steps to
# keep the whole run well inside its time limit
PROC_OVERRIDES = (("num_layers", 4),)
PROC_STEPS = 1
# the training parity phases (9, 15, 22) at B=2: their CPU sides are the
# script's slowest (zamba2's 38–42 s at B=4, the others 12–13 s)
PARITY_LAYERS, PARITY_B, PARITY_S = 4, 2, 128
SSM_TRAIN_PARITY_LAYERS = 2     # phase 15's mamba2
# phase 15's zamba2 parity: the fewest blocks (period 7) that hold one
# application of the shared block with Mamba2 blocks on both sides, over
# 32 tokens (its CPU side, 28–30 s at 128 and 20–25 s at 64, is the
# script's slowest)
HYB_TRAIN_PARITY_LAYERS = 8
HYB_TRAIN_PARITY_S = 32
TRAIN_LR = dict(lr=1e-3, warmup_steps=1)   # a step above a bf16 ulp

# phase 12: the training entry point at full width (0 keeps the config's
# own width and vocab), its depth cut to 2 of the config's 24 layers,
# phase 8's shapes
TRAIN_CLI_LAYERS = 2
TRAIN_CLI = ["--arch", ARCH, "--jobs", "2", "--steps", "2", "--batch-size",
             "16", "--group-size", "4", "--max-new-tokens", "64",
             "--seq-len", "128", "--layers", str(TRAIN_CLI_LAYERS),
             "--d-model", "0", "--vocab", "0"]
# phase 13: the jobs the director places, phase 8's shapes with 16 new
# tokens a step
CP_STEPS = {"auto-a": 3, "auto-b": 3, "auto-c": 2}
CP_NEW = 16
MEM_TOL = 0.1e9            # remove_job's release, against the job's bytes


# phase 29: the cost model's mamba2 step at full width cut to 4 layers;
# the per-launch work of PERF.md's bound column, (FLOPs, bytes), at
# qwen2-0.5b's prefill (K1), last decode step (K2) and mamba2's prefill (K3)
COST_SSM_LAYERS = 4
# phase 32: the one card seen as TP_DEVICES virtual devices, carved into
# groups of TP_SLICE; the jobs generate at the serving path's prompt
TP_DEVICES, TP_SLICE = 4, 2
TP_LAYERS = 6               # phase 32's depth, a quarter of qwen2-0.5b's
# one step a job (cut from two, for the whole run's time)
TP_TRAIN = dict(TRAIN, prompt_len=P, seq_len=P + TRAIN["max_new_tokens"],
                steps=1)
# phases 33-34: the MoE, ssm and hybrid families over groups of TP_SLICE
# (and one generate over TP_DEVICES) virtual devices. Qwen3-30B-A3B served
# at full width cut to EP_LAYERS of 48 layers (1.25 GB of weights a
# layer), EP_ROUNDS generates over 2 devices; granite's two GRPO jobs at
# GRANITE_LAYERS; mamba2 at SSM_TP_LAYERS (serving), SSM_TRAIN_LAYERS
# (phase 14's training) and SSM_TP_PARITY_LAYERS (logits over 2 and 4
# devices); zamba2 served at HYB_TP_LAYERS blocks (2 applications of the
# shared block)
EP_LAYERS, EP_ROUNDS = 12, 1
EP4_LAYERS, SSM_TP4_LAYERS = 6, 8       # the generates over 4 devices
SSM_TP_LAYERS = 16
SSM_TP_PARITY_LAYERS = 16
HYB_TP_LAYERS = 15
# phase 35: gemma2 at 8 of 46 layers over 2 devices (1.13 GB a layer, the
# tied embedding 2.36 GB: 11.42 GB, 5.71 a device) and at 4 over 4; two
# whisper jobs at 8 + 8 layers over 2 devices and one generate at 4 + 4
# over 4; vision at 10 of 100 layers over 4 (21.32 GB, 5.33 a device).
# Logits at the parity phases' depths; update_actor of gemma2 at 2 layers
# and of whisper at 2 + 2 on a slice against one device
GEMMA_TP_LAYERS, GEMMA_TP4_LAYERS = 8, 4
WHISPER_TP_LAYERS, WHISPER_TP4_LAYERS = 8, 4
XATTN_TRAIN_LAYERS = 2
# phase 36: process-mode groups of TP_SLICE virtual devices, each in its
# own child; phase 8's jobs at full width cut to 4 of 24 layers (1.96 GB of
# train state a job), one step each; the logits check at 2 layers, B=2,
# prompt 64, greedy, 8 new
PROC_TP_LAYERS = 4
PROC_TP_OVERRIDES = (("num_layers", PROC_TP_LAYERS),)
PROC_TP_PARITY_LAYERS, PROC_TP_PARITY_NEW = 2, 8
PROC_TP_PARITY_OVERRIDES = (("num_layers", PROC_TP_PARITY_LAYERS),)
# phase 37: the data and pod axes, the card seen as 4 virtual devices.
# qwen2-0.5b at full width cut to DP_LAYERS of 24 layers on a (2, 2)
# data x model mesh (phase 8's update at B=16, 8 a row, packed to 128;
# a generate of 64 at prompt 128), its prefill at DP_POD_LAYERS on a
# (2, 1, 2) pod x data x model mesh; zamba2-7b at DP_HYB_LAYERS blocks (one
# application of the shared block) decoding one sequence over a cache of
# DP_CP_T slots split over data = 2 (the long rules), its prompt
# DP_CP_P long so that both blocks of the cache hold live keys
DP_LAYERS, DP_POD_LAYERS = 4, 2
DP_HYB_LAYERS, DP_CP_T, DP_CP_P = 8, 8192, 6000
PERF_WORK = {"flash_attention": (473_432_064, 8_388_608),
             "decode_attention": (11_010_048, 1_630_208),
             "ssd": (53_812_920_320, 216_531_264)}


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
    """Input sets enough to rotate past the L2 cache; at most 128, which
    leaves only calls under 0.8 MB (the examples' widths) in L2, as their
    callers find them."""
    return max(2, min(128, math.ceil(2 * L2_BYTES / bytes_per_call)))


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

    # the MoE paths: Qwen3-30B-A3B's prefill and last decode step (GQA 8:1,
    # head_dim 128), granite's generate prefill (S=64), training forward
    # (S=128) and last decode step (GQA 3:1, head_dim 64)
    print("phase 3: K1 and K2 at the MoE paths' shapes (bf16: Qwen3-30B-A3B "
          "H=32 K=4 D=128, granite H=24 K=8 D=64)")
    t_cap = MOE_P + N_NEW
    g_prompt, g_seq = TRAIN["prompt_len"], TRAIN["seq_len"]
    records["flash_attention"]["qwen3_moe"] = flash_timing(
        torch, randn, B, MOE_P, MOE_H, MOE_KH, MOE_D, iters=100)
    records["flash_attention"]["granite_prefill"] = flash_timing(
        torch, randn, B, g_prompt, GRANITE_H, GRANITE_KH, GRANITE_D)
    records["flash_attention"]["granite_training"] = flash_timing(
        torch, randn, B, g_seq, GRANITE_H, GRANITE_KH, GRANITE_D)
    records["decode_attention"]["qwen3_moe"] = decode_timing(
        torch, randn, B, t_cap, t_cap - 1, 500, MOE_H, MOE_KH, MOE_D)
    records["decode_attention"]["granite"] = decode_timing(
        torch, randn, B, g_seq, g_seq - 1, 500, GRANITE_H, GRANITE_KH,
        GRANITE_D)

    # gemma2-27b: K1 at the B=16 prefill (the global and the local layers)
    # and at the long B=1 prefill, where the window cuts; K2 at the last
    # step of each round (the long round's global layers read every key),
    # then its window's first key mid-chunk and mid-split
    print("phase 3: K1 and K2 at gemma2-27b's shapes (bf16, H=32 K=16 "
          "D=128, softcap 50, scale 1/12, window 4096)")
    gem = dict(softcap=GEMMA_CAP, scale=GEMMA_SCALE)
    local = dict(gem, window=GEMMA_WINDOW)
    heads = (GEMMA_H, GEMMA_KH, GEMMA_D)
    fa, de = records["flash_attention"], records["decode_attention"]
    fa["gemma2"] = flash_timing(torch, randn, B, GEMMA_P, *heads, iters=100,
                                **gem)
    fa["gemma2_local"] = flash_timing(torch, randn, B, GEMMA_P, *heads,
                                      iters=100, **local)
    fa["gemma2_long_local"] = flash_timing(torch, randn, 1, GEMMA_LONG_P,
                                           *heads, iters=20, **local)
    fa["gemma2_long_global"] = flash_timing(torch, randn, 1, GEMMA_LONG_P,
                                            *heads, iters=20, **gem)
    t_cap, t_long = GEMMA_P + N_NEW, GEMMA_LONG_P + N_NEW
    de["gemma2_local"] = decode_timing(torch, randn, B, t_cap, t_cap - 1,
                                       500, *heads, **local)
    de["gemma2_long_local"] = decode_timing(torch, randn, 1, t_long,
                                            t_long - 1, 200, *heads, **local)
    de["gemma2_long_global"] = decode_timing(torch, randn, 1, t_long,
                                             t_long - 1, 200, *heads, **gem)
    de["gemma2_window_check"] = decode_window_check(torch, randn)

    # whisper-large-v3 (MHA 20:20, D=64): K1 non-causal at the encoder (S =
    # T = 1500) and the cross-attention prefill (S = 128 over T = 1500), K1
    # causal at the decoder's self-attention prefill (S = T = 128), K2 at
    # the cross-attention decode (every one of the 1500 keys) and at the
    # last step of the self-attention decode
    print("phase 3: K1 and K2 at whisper-large-v3's shapes (bf16, MHA "
          "H=K=20 D=64, non-causal over T=1500)")
    heads = (WHISPER_H, WHISPER_H, WHISPER_D)
    t_enc, t_cap = WHISPER_T, WHISPER_P + N_NEW
    fa["whisper_encoder"] = flash_timing(torch, randn, B, t_enc, *heads,
                                         iters=20, causal=False)
    fa["whisper_cross"] = flash_timing(torch, randn, B, WHISPER_P, *heads,
                                       iters=50, t=t_enc, causal=False)
    fa["whisper_self_prefill"] = flash_timing(torch, randn, B, WHISPER_P,
                                              *heads, iters=50)
    de["whisper_cross"] = decode_timing(torch, randn, B, t_enc, t_enc - 1,
                                        200, *heads)
    de["whisper_self"] = decode_timing(torch, randn, B, t_cap, t_cap - 1,
                                       500, *heads)

    # llama-3.2-vision-90b (GQA 64:8, D=128): K1 causal at the self-
    # attention prefill (S = T = 128) and non-causal at the cross-attention
    # prefill (S = 128 over the T = 1601 patch keys), K2 at the cross
    # decode (every one of the 1601 keys) and at the last step of the self
    # decode
    print("phase 3: K1 and K2 at llama-3.2-vision-90b's shapes (bf16, GQA "
          "H=64 K=8 D=128, non-causal over T=1601)")
    heads = (VISION_H, VISION_KH, VISION_D)
    t_vis, t_cap = VISION_T, VISION_P + N_NEW
    fa["vision_self_prefill"] = flash_timing(torch, randn, B, VISION_P,
                                             *heads, iters=50)
    fa["vision_cross_prefill"] = flash_timing(torch, randn, B, VISION_P,
                                              *heads, iters=50, t=t_vis,
                                              causal=False)
    de["vision_cross_decode"] = decode_timing(torch, randn, B, t_vis,
                                              t_vis - 1, 200, *heads)
    de["vision_self_decode"] = decode_timing(torch, randn, B, t_cap,
                                             t_cap - 1, 500, *heads)

    print("phase 3: K1 and K2 at the examples' head widths (bf16, H=4 K=2: "
          "D=16 built, D=12 padded to 16, D=32 built)")
    fa["examples_d16"] = flash_timing(torch, randn, 8, 32, EX_H, EX_KH, 16)
    fa["examples_d12"] = flash_timing(torch, randn, 8, 12, EX_H, EX_KH, 12)
    de["examples_d16"] = decode_timing(torch, randn, 4, 16, 15, 500, EX_H,
                                       EX_KH, 16)
    de["examples_d12"] = decode_timing(torch, randn, 8, 18, 17, 500, EX_H,
                                       EX_KH, 12)
    fa["examples_check"], de["examples_check"] = head_width_checks(
        torch, randn)
    for name, rows in (("flash_attention", ("zamba2", "qwen3_moe",
                                            "granite_prefill",
                                            "granite_training", "gemma2",
                                            "gemma2_local",
                                            "gemma2_long_local",
                                            "gemma2_long_global",
                                            "whisper_encoder",
                                            "whisper_cross",
                                            "whisper_self_prefill",
                                            "vision_self_prefill",
                                            "vision_cross_prefill",
                                            "examples_d16", "examples_d12",
                                            "examples_check")),
                       ("decode_attention", ("zamba2", "qwen3_moe",
                                             "granite", "gemma2_local",
                                             "gemma2_long_local",
                                             "gemma2_long_global",
                                             "whisper_cross",
                                             "whisper_self",
                                             "vision_cross_decode",
                                             "vision_self_decode",
                                             "examples_d16", "examples_d12",
                                             "examples_check"))):
        rec = records[name]
        rec["max_abs_err"] = max([rec["max_abs_err"]]
                                 + [rec[r]["max_abs_err"] for r in rows])
    de["max_abs_err"] = max(de["max_abs_err"],
                            de["gemma2_window_check"]["max_abs_err"])
    return records


def head_width_checks(torch, randn):
    """K1 and K2 at D = 12 (padded), 16 and 32 against their plain
    versions: K1 causal with a window and non-causal over a ragged T, K2
    at a short cache and over one long cache of 16 splits, all of the cache
    and a window of 1,000 keys. Returns the two kernels' check records."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops, ref

    g = EX_H // EX_KH
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k1, k2 = [], []
    for d in (12, 16, 32):
        for s, t, kw in ((100, 100, dict(causal=True, window=37)),
                         (77, 131, dict(causal=False))):
            q, k, v = (Q_SCALE * randn(4, s, EX_H, d), randn(4, t, EX_KH, d),
                       randn(4, t, EX_KH, d))
            k1.append(check_close(
                torch, f"K1 B=4 S={s} T={t} H={EX_H} K={EX_KH} D={d} {kw}",
                ops.flash_attention(q, k, v, **kw),
                ref.ref_attention(q, k.repeat_interleave(g, 2),
                                  v.repeat_interleave(g, 2), **kw)))
        for b, t, pos, kw in ((4, 40, 30, {}), (1, EX_LONG_T, 4000, {}),
                              (1, EX_LONG_T, 4000, dict(window=1000))):
            q, kc, vc = (Q_SCALE * randn(b, EX_H, d), randn(b, t, EX_KH, d),
                         randn(b, t, EX_KH, d))
            splits = dec.splits_for(b, EX_KH, t, sms)
            k2.append(check_close(
                torch, f"K2 B={b} T={t} H={EX_H} K={EX_KH} D={d} pos={pos} "
                f"{kw} ({splits} splits)",
                ops.decode_attention(q, kc, vc, pos, **kw),
                ref.ref_decode_attention(q, kc, vc, pos, **kw)))
    return ({"widths": [12, 16, 32], "max_abs_err": max(k1)},
            {"widths": [12, 16, 32], "max_abs_err": max(k2)})


def flash_timing(torch, randn, b, s, h, kh, d, iters=200, *, t=None,
                 causal=True, **opts):
    """K1 at one shape, S query rows over T = ``t`` (default S) keys,
    causal or not (``opts``: window, softcap, scale): checked against its
    plain version, then timed (kernel, plain, the library call; host-timed
    and as a CUDA graph) beside its bound, the inputs rotated past the L2
    cache. The library call is SDPA, or without one that takes a softcap,
    ``flex_attention`` compiled (``flex_call``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import bound

    g = h // kh
    t = t or s
    kw = dict(causal=causal, **opts)
    window = opts.get("window", 0)
    # q, k, v read once and the output written once, bf16; a causal row i
    # sees min(i + 1, window) keys, a non-causal one all T
    flops, per_call = ops.flash_attention_work(b, s, t, h, kh, d, 2,
                                               causal=causal, window=window)
    sets = [(Q_SCALE * randn(b, s, h, d), randn(b, t, kh, d),
             randn(b, t, kh, d)) for _ in range(n_sets(per_call))]
    q, k, v = sets[0]
    shape = (f"B={b} S=T={s}" if t == s else f"B={b} S={s} T={t}") + \
        f" H={h} K={kh} D={d} " + ("causal" if causal else "non-causal") + \
        "".join(f" {key} {val}" for key, val in opts.items())
    err = check_close(torch, shape, ops.flash_attention(q, k, v, **kw),
                      ref.ref_attention(q, k.repeat_interleave(g, 2),
                                        v.repeat_interleave(g, 2), **kw))

    def kernel(q, k, v):
        return ops.flash_attention(q, k, v, **kw)

    if opts.get("softcap") or window:
        library = flex_call(torch, s, s, 0, **opts)
    else:
        def library(q, k, v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True)

        library.label = "sdpa"

    t_kernel = time_ms(torch, kernel, sets, iters)
    t_plain = time_ms(torch, lambda q, k, v: ref.ref_attention(
        q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2), **kw),
        sets, max(4, iters // 4))
    d_kernel = device_ms(torch, kernel, sets, 20)
    t_lib, d_lib = library_times(torch, library, sets, iters, 20)
    t_bound, by = bound(per_call, flops)
    print(f"  timing {shape}: kernel {t_kernel} ms (device {d_kernel} ms), "
          f"plain {t_plain} ms, {library.label} "
          f"{t_lib} ms (device {d_lib} ms), bound {t_bound} ms ({by}: "
          f"{per_call} B, {flops} FLOP)")
    return dict(shape=shape, max_abs_err=err, ms=t_kernel,
                device_ms=d_kernel, plain_ms=t_plain, bound_ms=t_bound,
                bound_by=by, library_ms=t_lib, library_device_ms=d_lib,
                library=library.label)


def flex_call(torch, s, t, pos, *, window=0, softcap=None, scale=None):
    """The library yardstick where SDPA has no softcap:
    ``torch.nn.attention.flex_attention`` compiled, with a softcap
    ``score_mod`` and a causal (windowed) ``mask_mod``, on the port's
    (B, S, H, D) layout. ``s`` query rows at positions pos.. over ``t``
    keys: (S, S, 0) for a prefill, (1, T, pos) for a decode step. It is
    timed only, never on the port's path; everything that can fail runs
    in the call, whose failure ``library_times`` records as the row's
    library time."""

    def score_mod(score, b, h, q_idx, kv_idx):
        if softcap is None:
            return score
        return softcap * torch.tanh(score / softcap)

    def mask_mod(b, h, q_idx, kv_idx):
        ok = kv_idx <= q_idx + pos
        if window:
            ok = ok & (kv_idx > q_idx + pos - window)
        return ok

    block = []                        # made at the first call

    def call(q, k, v):
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        if not block:
            block.append(create_block_mask(mask_mod, None, None, s, t,
                                           device="cuda"))
        decode = q.ndim == 3
        q = q[:, :, None] if decode else q.transpose(1, 2)
        out = _compiled(torch, flex_attention)(
            q, k.transpose(1, 2), v.transpose(1, 2), score_mod=score_mod,
            block_mask=block[0], scale=scale, enable_gqa=True)
        return out[:, :, 0] if decode else out.transpose(1, 2)

    call.label = "flex_attention (compiled)"
    return call


def flex_warmup(torch, dev):
    """One small compiled ``flex_attention`` call, made in a thread while
    phase 2's ``nvcc`` builds: the compiler's first call (its imports, its
    worker pool, its first kernels: some 35 s, more than the build) is
    then done before phase 3's yardsticks, whose own compiles take some
    6 s each. Returns the thread, which phase 3 joins first; a
    failure is printed and left to the yardsticks, which time whatever
    works."""
    import threading

    def run():
        try:
            t0 = time.perf_counter()
            gen = torch.Generator(device=dev).manual_seed(3)
            q, k, v = (torch.randn((1, 128, 2, 64), generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for _ in range(3))
            flex_call(torch, 128, 128, 0, softcap=GEMMA_CAP,
                      scale=GEMMA_SCALE)(q, k, v)
            torch.cuda.synchronize(dev)
            print(f"  flex_attention warmed up in a thread in "
                  f"{time.perf_counter() - t0} s (beside the build)")
        except Exception as e:             # a yardstick, never on the path
            print(f"  flex_attention's warm-up failed: {e!r}")

    thread = threading.Thread(target=run, name="flex-warmup", daemon=True)
    thread.start()
    return thread


@functools.lru_cache(maxsize=None)
def _compiled(torch, fn):
    """``torch.compile(fn)``, once: a new shape recompiles it, the same
    shape reuses it. Phases 3 and 31 compile it for more shapes than
    dynamo's default of 8 recompiles, past which it would run uncompiled."""
    config = torch._dynamo.config
    name = "recompile_limit" if hasattr(config, "recompile_limit") \
        else "cache_size_limit"
    setattr(config, name, max(getattr(config, name), 64))
    return torch.compile(fn)


def library_times(torch, library, sets, iters, reps):
    """The library call's host-timed and CUDA-graph ms; a library call
    that fails (its compile, a graph capture) gives its reason in place of
    the times."""
    try:
        t0 = time.perf_counter()
        library(*sets[0])
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        t_lib = time_ms(torch, library, sets, iters)
        if first > 5:
            print(f"  {library.label}: first call "
                  f"{first} s (its compile)")
    except Exception as e:                # a yardstick, never on the path
        print(f"  {library.label} failed: {e!r}")
        return None, f"not measured: {type(e).__name__}"
    try:
        d_lib = device_ms(torch, library, sets, reps)
    except Exception as e:
        print(f"  {library.label} as a CUDA graph "
              f"failed: {e!r}")
        torch.cuda.synchronize()
        d_lib = f"not measured: {type(e).__name__}"
    return t_lib, d_lib


def decode_timing(torch, randn, b, t_cap, pos, iters, h=H, kh=KH, d=D,
                  **opts):
    """K2 at one shape (``opts``: window, softcap, scale): checked against
    its plain version, then timed (kernel, plain, the library call;
    host-timed and as a CUDA graph) beside its bound, the caches rotated
    past the L2 cache. The bound counts the live keys only: those in the
    window."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import bound

    window = opts.get("window", 0)
    live = min(pos + 1, window or pos + 1)
    # q read and the output written once; K and V cache rows of the live
    # keys read once
    flops, per_call = ops.decode_attention_work(b, h, kh, d, pos, 2, 2,
                                                window=window)
    sets = [(Q_SCALE * randn(b, h, d), randn(b, t_cap, kh, d),
             randn(b, t_cap, kh, d)) for _ in range(n_sets(per_call))]
    q, kc, vc = sets[0]
    shape = f"B={b} T={t_cap} H={h} K={kh} D={d} pos={pos}" + "".join(
        f" {key} {val}" for key, val in opts.items())
    err = check_close(torch, shape, ops.decode_attention(q, kc, vc, pos,
                                                         **opts),
                      ref.ref_decode_attention(q, kc, vc, pos, **opts))

    def kernel(q, k, v):
        return ops.decode_attention(q, k, v, pos, **opts)

    if opts.get("softcap"):
        library = flex_call(torch, 1, t_cap, pos, **opts)
    else:
        def library(q, k, v):
            lo = pos + 1 - live
            return F.scaled_dot_product_attention(
                q[:, :, None], k[:, lo:pos + 1].transpose(1, 2),
                v[:, lo:pos + 1].transpose(1, 2), enable_gqa=True,
                scale=opts.get("scale"))[:, :, 0]

        library.label = "sdpa"

    reps = max(50, 1000 // len(sets))
    t_kernel = time_ms(torch, kernel, sets, iters)
    t_plain = time_ms(torch, lambda q, k, v: ref.ref_decode_attention(
        q, k, v, pos, **opts), sets, iters // 5)
    d_kernel = device_ms(torch, kernel, sets, reps)
    t_lib, d_lib = library_times(torch, library, sets, iters, reps)
    t_bound, by = bound(per_call, flops)
    print(f"  timing {shape}: kernel {t_kernel} ms (device {d_kernel} ms), "
          f"plain {t_plain} ms, {library.label} "
          f"{t_lib} ms (device {d_lib} ms), bound {t_bound} ms ({by}: "
          f"{per_call} B, {flops} FLOP)")
    return dict(shape=shape, max_abs_err=err, ms=t_kernel, device_ms=d_kernel,
                plain_ms=t_plain, bound_ms=t_bound, bound_by=by,
                library_ms=t_lib, library_device_ms=d_lib,
                library=library.label)


def decode_window_check(torch, randn):
    """K2's window starting mid-chunk and mid-split: an argument-level
    check at gemma2's heads over the long round's cache (B=1, T=4416: 16
    splits of 276 keys), window 100 and softcap 50. At pos 2912 the window
    starts at key 2813, inside split 10 (2760..3035) and its chunk
    2808..2823; at pos 3090 at 2991 (chunk 2984..2999 of split 10), and
    its keys run on into split 11."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops, ref

    b, t = 1, GEMMA_LONG_P + N_NEW
    h, kh, d = GEMMA_H, GEMMA_KH, GEMMA_D
    splits = dec.splits_for(b, kh, t, torch.cuda.get_device_properties(
        0).multi_processor_count)
    span = -(-t // splits)
    q, kc, vc = Q_SCALE * randn(b, h, d), randn(b, t, kh, d), \
        randn(b, t, kh, d)
    errs = []
    for pos in (2912, 3090):
        lo = pos - 99
        split, offset = divmod(lo, span)
        print(f"  window 100 at pos {pos}: first key {lo}, split {split} of "
              f"{splits} ({span} keys), {offset % dec.CHUNK} keys into its "
              f"chunk")
        if offset % dec.CHUNK == 0:
            fail("the window check's first key is not mid-chunk and "
                 "mid-split")
        opts = dict(window=100, softcap=GEMMA_CAP, scale=GEMMA_SCALE)
        errs.append(check_close(
            torch, f"B={b} T={t} H={h} K={kh} D={d} pos={pos} window 100",
            ops.decode_attention(q, kc, vc, pos, **opts),
            ref.ref_decode_attention(q, kc, vc, pos, **opts)))
    return dict(window=100, positions=[2912, 3090], max_abs_err=max(errs))


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
    from repro_torch.launch.mesh import bound

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
    # x, dt, B, C (and A) read once; y and the f32 final state written
    # once; the operations count each chunk's causal half of the scores
    flops, per_call = ops.ssd_work(b, s, h, p, 1, n, SSM_CHUNK, 2, 2)
    sets = [inputs(s) for _ in range(n_sets(per_call))]

    def kernel(*a):
        return ops.ssd(*a, chunk=SSM_CHUNK)

    t_kernel = time_ms(torch, kernel, sets, 20)
    t_plain = time_ms(torch, lambda *a: ref.ref_ssd(*a, chunk=SSM_CHUNK),
                      sets, 4)
    d_kernel = device_ms(torch, kernel, sets, 10)
    t_bound, by = bound(per_call, flops)
    shape = f"B={b} S={s} H={h} P={p} N={n} chunk={min(SSM_CHUNK, s)}"
    print(f"  timing {shape}: kernel {t_kernel} ms (device {d_kernel} ms), "
          f"plain {t_plain} ms, no library call computes an SSD scan, bound "
          f"{t_bound} ms ({by}: {per_call} B, {flops} FLOP)")
    return dict(shape=shape, max_abs_err=max(errs), ms=t_kernel,
                device_ms=d_kernel, plain_ms=t_plain, bound_ms=t_bound,
                bound_by=by, library_ms=None, library_device_ms=None)


# ------------------------------------------------ phases 4, 6: serving

def profile_round(torch, run):
    """``run()`` once more (the resident job, no context switch) with the
    device traced: the card's busy share and its kernel time by name,
    summed over the profiler's raw device events (``key_averages`` would
    build a Python event tree: 143 s for a Qwen3-30B-A3B generate's
    542,451 events). Returns the run's result and the busy seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        wall = time.perf_counter() - t0
    t_exit = time.perf_counter() - t0 - wall
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ns, n = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), n + 1)
    busy = sum(ns for ns, _ in by_name.values()) / 1e9
    print(f"  profiled round: {wall * 1e3} ms wall, device busy {busy * 1e3} "
          f"ms ({busy / wall} of wall), "
          f"{sum(n for _, n in by_name.values())} device events; after the "
          f"round the profiler's exit took {t_exit} s, the sums "
          f"{time.perf_counter() - t0 - wall - t_exit} s")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the ten largest, then the port's own kernels wherever they rank
    for i, (name, (ns, n)) in enumerate(ranked):
        if i < 10 or any(tag in name for tag in PORT_KERNELS):
            print(f"    {ns / 1e6} ms  x{n}  {name[:90]}")
    return out, busy


def spec_bytes(cfg) -> int:
    """The bytes of a model's parameters, from its specs."""
    from repro_torch.models import common
    from repro_torch.models.registry import build_model

    specs = common.canonical_flat(build_model(cfg).param_specs())
    return sum(math.prod(sp.shape) * sp.dtype.itemsize
               for sp in specs.values())


def leaf_digests(torch, dep):
    """A digest of each of a deployment's parameter leaves, where they
    live (on the card when the job is resident)."""
    from repro_torch.models import common
    return {k: digest(torch, v)
            for k, v in common.canonical_flat(dep.wpg.params()).items()}


def serve_phase(torch, dev, phase, arch, prompt_len, want, prompts=None,
                extras=None, order="ABAB", overrides=(), after_init=None):
    """The deployments of ``arch`` (a job each of ``order``'s letters) on
    group 0 through Router -> HRRS -> WPG -> rollout: INIT each, then a
    generate of each job in ``order``, then one more of the last job (no
    switch) under the profiler. ``want``: the launches each generate must
    make, per kernel (the counts set to 0 before each); ``prompts``: the
    rounds' prompts (MathDataset's by default), and ``extras`` their
    ``extra_inputs``, one each for ``order`` and, where given, one more
    for the profiled round (else it takes round 0's); ``overrides``: the
    deployments' config overrides; ``after_init(router, dep)``: run after
    each INIT, before the job's leaves are digested. Each generate peaks
    under 80 GB; each job holds its specs' bytes on the card, its leaves
    are bit-exact (digests on the card) after every round it runs; with
    two jobs, a switch moves the whole job or nothing each way, and at
    least three move one each way. Returns the router and the launches of
    the rounds of ``order``."""
    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.core.router import Router
    from repro_torch.kernels import ops
    from repro_torch.rl import data as data_lib

    jobs = sorted(set(order))
    cfg = get_config(arch).replace(**dict(overrides))
    want_bytes = spec_bytes(cfg)
    if prompts is None:
        batches = data_lib.MathDataset(seed=0).batches(B, prompt_len)
        prompts = [next(batches)[0] for _ in order]
    extras = extras or [{} for _ in prompts]
    shapes = {k: tuple(v.shape) for k, v in extras[0].items()}
    print(f"phase {phase}: serving {arch} at full width"
          + (f", overrides {dict(overrides)}" if overrides else "")
          + f", job{'s' * (len(jobs) > 1)} {' and '.join(jobs)} on group 0 "
          f"({want_bytes} B of parameters each; B={B}, prompt "
          f"{prompt_len}, {N_NEW} new, temperature 0.7"
          + (f", extra_inputs {shapes}" if shapes else "") + ")")
    router = Router()                 # the CUDA devices; one card here
    deps = {job: router.deploy(api.DeploymentSpec(
        deployment_id=f"rollout-{job}", job_id=job, model_name=arch,
        role="rollout", overrides=overrides), group_id=0) for job in jobs}
    kept = {}
    with router:
        torch.cuda.reset_peak_memory_stats(dev)
        for seed, (job, dep) in enumerate(deps.items(), start=1):
            t0 = time.perf_counter()
            info = dep.init(seed=seed).wait(timeout=900)
            if after_init:
                after_init(router, dep)
            nbytes = router.state_managers[0].job_bytes(dep.wpg.job_prefix)
            kept[job] = leaf_digests(torch, dep)
            print(f"  INIT {job}: {time.perf_counter() - t0} s, "
                  f"{info['params']} parameters, {nbytes} B on the card; "
                  f"peak card memory {torch.cuda.max_memory_allocated(dev)} "
                  f"B")
            if nbytes != want_bytes:
                fail(f"INIT {job} holds {nbytes} B, not {want_bytes}")

        def run(job, r):
            return deps[job].generate(
                prompts[r], max_new_tokens=N_NEW, temperature=0.7,
                extra_inputs=extras[r] or None).wait(timeout=600)

        launches = {k: 0 for k in want}
        last = len(order) if len(prompts) > len(order) else 0
        for r, job in enumerate(order + order[-1]):
            profiled = r == len(order)
            torch.cuda.reset_peak_memory_stats(dev)
            ops.reset_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            out, busy = profile_round(torch, lambda: run(job, last)) \
                if profiled else (run(job, r), None)
            wall = time.perf_counter() - t0
            end.record()
            end.synchronize()
            grew = dict(ops.LAUNCHES)
            peak = torch.cuda.max_memory_allocated(dev)
            toks, logps = out["tokens"], out["logprobs"]
            if tuple(toks.shape) != (B, N_NEW) or toks.device.type != dev.type or \
                    not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()) \
                    or not bool(torch.isfinite(logps).all()):
                fail(f"round {r}: tokens {tuple(toks.shape)} on "
                     f"{toks.device} or logprobs out of range")
            if grew != want:
                fail(f"round {r}: launches {grew}, want {want}")
            if peak >= 80e9:
                fail(f"round {r}: peak card memory {peak} B")
            if leaf_digests(torch, deps[job]) != kept[job]:
                fail(f"round {r}: job {job}'s parameters changed")
            if not profiled:
                launches = {k: launches[k] + grew[k] for k in want}
            print(f"  generate {r} job {job}: wall {wall * 1e3} ms, device "
                  f"span {start.elapsed_time(end)} ms (events), device busy "
                  + (f"{busy * 1e3} ms (profiler)" if busy is not None
                     else "not measured (unprofiled round)")
                  + f"; {B * N_NEW / wall} tok/s ({int(out['alive'].sum())} "
                  f"live); launches {grew}; peak card memory {peak} B; "
                  f"{len(kept[job])} leaves bit-exact")
        print(f"  pinned host bytes held {pinned_bytes(torch)}")
    # a switch moves a whole job each way, or nothing on a side whose job
    # is already where it belongs (the first round's job is still resident
    # after the other's INIT); the log also records a target load with
    # nothing to offload, as the reference router does
    for s in router.switch_log:
        print(f"  switch to {s['to_job']}: offload {s['t_offload']} s "
              f"{s['offload_bytes']} B, load {s['t_load']} s "
              f"{s['load_bytes']} B")
        if {s["offload_bytes"], s["load_bytes"]} - {0, want_bytes}:
            fail(f"a switch moved {s['offload_bytes']} / {s['load_bytes']} "
                 f"B, not a whole job")
    for side in ("offload_bytes", "load_bytes"):
        n = sum(s[side] == want_bytes for s in router.switch_log)
        if len(jobs) > 1 and n < 3:
            fail(f"only {n} context switches moved a whole job ({side})")
    for dep in deps.values():
        print(f"  exec_log {dep.deployment_id}: {list(dep.wpg.exec_log)}")
    return router, launches


# ------------------------------------------------ phases 5, 7: parity

def side_logits(torch, model, params, d, prompt, forced, where, extra=None):
    """The prefill's logits, then each teacher-forced decode step's, with
    ``params`` and the prefill's ``extra`` inputs (whisper's frames) copied
    to device ``d``."""
    from repro_torch.models import common
    from repro_torch.rl.rollout import _pad_cache

    t0 = time.perf_counter()
    with torch.inference_mode():
        prm = common.tree_map(lambda t: t.to(d), params,
                              is_leaf=torch.is_tensor)
        batch = {"tokens": prompt.to(d),
                 **{k: v.to(d) for k, v in (extra or {}).items()}}
        lg, _, cache = model.forward(prm, batch, return_cache=True)
        steps = [lg.cpu()]
        cache = _pad_cache(cache, forced.shape[1])
        for i in range(forced.shape[1]):
            lg, cache = model.decode_step(
                prm, cache, {"tokens": forced[:, i:i + 1].to(d)})
            steps.append(lg.cpu())
    seconds = time.perf_counter() - t0
    print(f"  {where} side: {seconds} s")
    return steps, seconds


def parity_prompt(torch, cfg, b, p, n):
    """MathDataset prompts (B, p) and seeded forced tokens (B, n)."""
    from repro_torch.rl import data as data_lib

    prompt = torch.as_tensor(
        next(data_lib.MathDataset(seed=1).batches(b, p))[0], dtype=torch.long)
    forced = torch.randint(0, cfg.vocab_size, (b, n),
                           generator=torch.Generator().manual_seed(2))
    return prompt, forced


def parity_phase(torch, model, params, dev, phase, b=2, p=64, n=8,
                 against="cpu", cap=None, extra=None):
    """Prefill and teacher-forced decode logits on the card against the
    same parameters through the plain versions on the CPU, or (``against``
    "card plain") on the card with ``kernels/ref.py``'s attention called in
    place of K1 and K2. ``extra``: the prefill's inputs beside the tokens
    (whisper's frames), on the CPU. With ``cap``, the logits soft-capped at
    it are compared too and printed, not held. Returns the worst |diff| /
    tolerance and each side's seconds."""
    cfg = model.cfg
    prompt, forced = parity_prompt(torch, cfg, b, p, n)
    # the CPU test's bound of four bf16 ulps of the largest logit at 4
    # layers (tests/test_torch_model.py), grown with the square root of the
    # depth (whisper's: its encoder and decoder layers): independent bf16
    # roundings per layer add in quadrature
    layers = cfg.num_layers + cfg.encoder_layers
    rel_tol = 2.0 ** -6 * math.sqrt(layers / 4)
    print(f"phase {phase}: parity card vs {against}, {cfg.name} at "
          f"{layers} layers, B={b} P={p}, {n} teacher-forced decode "
          f"steps (tolerance {rel_tol} * max|logit|)")
    logits, seconds = {}, {}
    sides = (torch, model, params)
    logits["card"], seconds["card"] = side_logits(
        *sides, dev, prompt, forced, "card", extra)
    if against == "cpu":
        logits[against], seconds[against] = side_logits(
            *sides, torch.device("cpu"), prompt, forced, against, extra)
    else:
        with plain_attention():
            logits[against], seconds[against] = side_logits(
                *sides, dev, prompt, forced, against, extra)
    worst = 0.0
    for i, (gpu, cpu) in enumerate(zip(logits["card"], logits[against])):
        err = (gpu - cpu).abs().max().item()
        tol = rel_tol * cpu.abs().max().item()
        worst = max(worst, err / tol)
        agree = (gpu.argmax(-1) == cpu.argmax(-1)).float().mean().item()
        label = "prefill" if i == 0 else f"decode {i}"
        print(f"  {label}: max|diff| {err}, tolerance {tol}, argmax "
              f"agreement {agree}")
        if cap:
            g_cap, c_cap = (cap * torch.tanh(x / cap) for x in (gpu, cpu))
            print(f"    soft-capped at {cap}: max|diff| "
                  f"{(g_cap - c_cap).abs().max().item()}, the same bound from "
                  f"their max|logit| {rel_tol * c_cap.abs().max().item()}")
        if not (torch.isfinite(gpu).all() and err <= tol):
            fail(f"parity {label}: {err} > {tol}")
    return worst, seconds


@contextlib.contextmanager
def plain_attention():
    """K1's and K2's wrappers replaced by ``kernels/ref.py``'s attention,
    called on whatever device the tensors are: the check's own reference
    on the card, never the port's path."""
    from repro_torch.kernels import ops, ref

    def flash(q, k, v, *, causal=True, window=0, softcap=None, scale=None,
              q_chunk=256):
        g = q.shape[2] // k.shape[2]
        return ref.ref_attention(q, k.repeat_interleave(g, 2),
                                 v.repeat_interleave(g, 2), causal=causal,
                                 window=window, softcap=softcap, scale=scale)

    kept = ops.flash_attention, ops.decode_attention
    ops.flash_attention, ops.decode_attention = flash, \
        ref.ref_decode_attention
    try:
        yield
    finally:
        ops.flash_attention, ops.decode_attention = kept


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


def moment_sums(wpg):
    """Each f32 first-moment leaf's sum of magnitudes."""
    from repro_torch.models import common

    return {k: v.abs().sum().item() for k, v in
            common.canonical_flat(wpg.opt_state().mu).items()}


def digest(torch, t) -> int:
    """An order-sensitive digest of a tensor's bits, computed where the
    tensor lives, in slices (the temporaries are those of one slice)."""
    v = t.detach().reshape(-1).view(
        {2: torch.int16, 4: torch.int32}[t.element_size()])
    acc = 0
    for c in v.split(1 << 24):
        w = torch.arange(1, c.numel() + 1, device=c.device,
                         dtype=torch.int64)
        acc = acc * 1_000_003 + int((c.to(torch.int64) * w).sum())
    return acc


def guard_f32(torch, wpg, job, seen, checks, spent):
    """Wrap a WPG's ``offload`` and ``ensure_resident``: digest its f32
    entries (parameters such as the MoE router, the AdamW moments) on the
    card just before an offload, again once the load that brings them back
    is done, and log ``(job, leaves, bit-exact)`` in ``checks``. The
    digests' seconds are added to ``spent[0]``, so a wall time around the
    wrapped calls can leave them out."""
    sm = wpg.sm
    offload, load = wpg.offload, wpg.ensure_resident

    def f32():
        t0 = time.perf_counter()
        out = {k: digest(torch, sm.entries[k].ref)
               for k in sm.keys_for(wpg.job_prefix)
               if sm.entries[k].ref.dtype == torch.float32}
        spent[0] += time.perf_counter() - t0
        return out

    def run_offload(*args, **kw):
        if wpg.resident():
            seen[job] = f32()
        return offload(*args, **kw)

    def run_load():
        dt = load()
        if job in seen:
            want = seen.pop(job)
            checks.append((job, len(want), f32() == want))
        return dt

    wpg.offload, wpg.ensure_resident = run_offload, run_load


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


def train_phase(torch, dev, records, phase=8, arch=ARCH, overrides=None):
    """Two GRPO jobs' steps of ``arch`` through Router -> HRRS -> WPG at
    full width, then a seeded update and a profiled one. Returns the
    cluster."""
    from repro_torch.configs import get_config
    from repro_torch.core.cluster import PlexCluster
    from repro_torch.core.controller import JobConfig
    from repro_torch.kernels import ops

    overrides = TRAIN_OVERRIDES if overrides is None else overrides
    n_new = TRAIN["max_new_tokens"]
    print(f"phase {phase}: GRPO training {arch} at full width, "
          f"jobs A and B on group 0 ({TRAIN}, overrides {overrides}) "
          f"through PlexCluster.run(interleave=True)")
    cfg = get_config(arch).replace(**dict(overrides))
    cluster = PlexCluster(n_groups=1)     # the CUDA devices; one card here
    router = cluster.router
    ctls = {job: cluster.add_job(JobConfig(
        job_id=job, model_name=arch, seed=seed, overrides=overrides,
        **TRAIN)) for seed, job in enumerate("AB", start=1)}
    log, seen, checks, spent = [], {}, [], [0.0]
    for job, c in ctls.items():
        counted(c.dep.wpg, job, log)
        guard_f32(torch, c.dep.wpg, job, seen, checks, spent)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    billing = cluster.run(interleave=True)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"init": launches_per_op(cfg, "init", n_new),
            "generate": launches_per_op(cfg, "generate", n_new),
            "update_actor": launches_per_op(cfg, "update_actor", n_new)}
    for job, op, sec, grew in log:
        print(f"  job {job} {op}: {sec} s, launches {grew}")
        if grew != want[op]:
            fail(f"job {job} {op}: launches {grew}, want {want[op]}")
    print(f"  {len(log)} ops in {wall - spent[0]} s (the f32 digests' "
          f"{spent[0]} s left out of the {wall} s wall); launches "
          f"{launches}; peak card memory {peak} B (card total "
          f"{torch.cuda.get_device_properties(dev).total_memory} B)")
    sm = router.state_managers[0]
    nbytes = {job: sm.job_bytes(c.dep.wpg.job_prefix)
              for job, c in ctls.items()}
    print(f"  train state a job: {nbytes} B")
    for sw in router.switch_log:
        print(f"  switch to {sw['to_job']}: offload {sw['t_offload']} s "
              f"{sw['offload_bytes']} B, load {sw['t_load']} s "
              f"{sw['load_bytes']} B")
    moved = [sw for sw in router.switch_log if sw["t_offload"] > 0]
    if len(moved) < 3:
        fail(f"only {len(moved)} context switches offloaded a job")
    print(f"  f32 leaves across the switches (job, leaves, bit-exact): "
          f"{checks}")
    if len(checks) < 2 or not all(ok for _, _, ok in checks):
        fail(f"f32 leaves across the switches: {checks}")
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
    # an init and a generate and an update a step, each billed
    submitted = 1 + 2 * TRAIN["steps"]
    for job, c in ctls.items():
        rec = billing[job]
        wpg = c.dep.wpg
        print(f"  bill {job}: busy {rec.busy_seconds} s, switch "
              f"{rec.switch_seconds} s, steps {rec.steps}, gpu-seconds a "
              f"step {rec.gpu_seconds_per_step()}")
        check_bill(cluster, rec, [wpg], submitted, TRAIN["steps"])
    for job, c in ctls.items():
        if len(c.metrics_log) != TRAIN["steps"]:
            fail(f"job {job}: {len(c.metrics_log)} steps recorded")
        for i, (m, r) in enumerate(zip(c.metrics_log, c.reward_log)):
            print(f"  job {job} step {i}: loss {m['loss']}, grad_norm "
                  f"{m['grad_norm']}, lr {m['lr']}, mean reward {r}")
            if not all(math.isfinite(v) for v in m.values()):
                fail(f"job {job} step {i}: non-finite metrics {m}")
    for k, per_gen in want["generate"].items():
        if per_gen or want["update_actor"][k]:
            records[k].setdefault("train_launches", {})[arch] = dict(
                total=launches[k], per_generate=per_gen,
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

    mu0 = moment_sums(wpg)
    # the MoE's router and expert leaves, which the update must move
    moe_keys = [k for k in keys if "/params/layers/moe/" in k]
    moe0 = {k: digest(torch, sm.entries[k].ref) for k in moe_keys}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    m = done(dep.update_actor(batch))
    t_update = time.perf_counter() - t0
    mu1 = moment_sums(wpg)
    print(f"  seeded update_actor (job A, B={TRAIN['batch_size']} "
          f"S={TRAIN['seq_len']}): {wpg.exec_log[-1][1]} s ({t_update} s "
          f"from submit to result), loss {m['loss']}, pg_loss "
          f"{m['pg_loss']}, kl {m['kl']}, aux {m['aux']}, grad_norm "
          f"{m['grad_norm']}, lr {m['lr']}; peak card memory "
          f"{torch.cuda.max_memory_allocated(dev)} B")
    still_moe = [k for k in moe_keys
                 if digest(torch, sm.entries[k].ref) == moe0[k]]
    if moe_keys:
        print(f"  MoE leaves moved by the update: "
              f"{len(moe_keys) - len(still_moe)} of {len(moe_keys)}")
    if still_moe:
        fail(f"the seeded update left {still_moe} unchanged")
    still = [k for k in mu1 if mu1[k] == mu0[k]]
    print(f"  f32 first moments changed in {len(mu1) - len(still)} of "
          f"{len(mu1)} leaves (unchanged: {still})")
    if not m["grad_norm"] > 0 or set(still) - {"layers/attn/bk"}:
        fail("the seeded update did not move the moments")
    if sm.keys_for(wpg.job_prefix) != keys or any(
            sm.entries[k].ref.data_ptr() != p for k, p in ptrs.items()):
        fail("the update replaced the job's tensors")
    print(f"  {len(keys)} entries kept their tensors across the update")
    profile_round(torch, lambda: done(dep.update_actor(batch)))
    return cluster


def launches_per_op(cfg, op, n_new):
    """The kernel launches one op of a GRPO or PPO step makes: K1 in each
    attention layer's prefill or training forward, K2 in each decode step
    of each attention layer, K3 in each Mamba2 block's prefill or training
    forward. whisper's attention layers are its encoder's and, twice, its
    decoder's (self and cross); vision's cross layers attend as its self
    layers do. An op that takes a gradient (``GRAD_OPS``) runs every
    layer group's forward twice under ``cfg.remat`` "full" or "dots" (the
    forward, then its recomputation in the backward), so its K1 and K3
    launch twice a layer; once under "none"."""
    from repro_torch.models import hybrid

    mamba, decode = 0, None
    if cfg.family == "hybrid":
        attn = hybrid._layout(cfg)[0]
        mamba = cfg.num_layers - attn
    elif cfg.family == "ssm":
        attn, mamba = 0, cfg.num_layers
    elif cfg.family == "audio":
        attn, decode = cfg.encoder_layers + 2 * cfg.num_layers, \
            2 * cfg.num_layers
    else:
        attn = cfg.num_layers
    decode = attn if decode is None else decode
    zero = {"flash_attention": 0, "decode_attention": 0, "ssd": 0}
    if op in ("init", "optim_step", "sync_weights"):
        return zero
    runs = 2 if op in GRAD_OPS and cfg.remat != "none" else 1
    return {"flash_attention": runs * attn,
            "decode_attention": decode * n_new if op == "generate" else 0,
            "ssd": runs * mamba}


# the ops that differentiate the model (the others run it without a
# gradient: generate under inference_mode, forward under no_grad)
GRAD_OPS = ("update_actor", "forward_backward")


def check_bill(cluster, rec, wpgs, submitted, steps):
    """Fail unless every op the job's deployments ran was billed, they ran
    ``submitted`` ops, the job's busy seconds are their exec logs' and
    ``steps`` steps were billed."""
    billed = sum(cluster._billed_ops.get(w.spec.deployment_id, 0)
                 for w in wpgs)
    ran = sum(len(w.exec_log) for w in wpgs)
    logged = sum(dt for w in wpgs for _, dt in w.exec_log)
    if billed != submitted or ran != submitted or rec.steps != steps:
        fail(f"{rec.job_id}: {billed} ops billed of {ran} run, {submitted} "
             f"submitted; {rec.steps} steps billed")
    if not math.isclose(rec.busy_seconds, logged):
        fail(f"{rec.job_id}: busy {rec.busy_seconds} s is not its exec "
             f"logs' {logged} s")


def update_parity(torch, dev, phase, arch, overrides, s=PARITY_S):
    """One update_actor of ``arch`` (cut by ``overrides``) on the card and
    on the CPU's plain path (without remat) from the same parameters and
    a batch of PARITY_B rows of ``s`` tokens: loss,
    pg_loss, kl and the MoE aux loss (0 without experts) within 5e-2,
    grad_norm within 5 %, each leaf's f32 mu within 5e-2 * max|mu|.
    Returns the worst |diff| / tolerance."""
    from repro_torch.core import api
    from repro_torch.core.state_manager import StateManager
    from repro_torch.core.worker import WorkerProcessGroup
    from repro_torch.launch.mesh import MeshSlice
    from repro_torch.models import common
    from repro_torch.train.optimizer import AdamWConfig

    spec = api.DeploymentSpec(
        deployment_id=f"parity-{arch}", job_id="P", model_name=arch,
        role="train", overrides=overrides)
    adamw = AdamWConfig(**TRAIN_LR)
    card = WorkerProcessGroup(spec, StateManager(
        mesh_slice=MeshSlice(0, dev)), adamw_cfg=adamw)
    # the CPU side, the reference, computes the same function without the
    # card path's recomputation (cfg.remat), a quarter of its time
    cpu = WorkerProcessGroup(dataclasses.replace(
        spec, overrides=tuple(overrides) + (("remat", "none"),)),
        StateManager(), adamw_cfg=adamw)
    cfg = card.cfg
    print(f"phase {phase}: training parity card vs CPU plain, {arch} at "
          f"full width cut to {cfg.num_layers} layers (depth only), "
          f"B={PARITY_B} S={s}, AdamW {TRAIN_LR}"
          + (", tied embedding scaled by 1/64" if cfg.tie_embeddings
             else ""))
    # the seeded init's unit-scale tied embedding gives logits near 1e3
    # (a one-hot policy, mean token logprob about -800), where one bf16
    # step of a logit is 4 nats and the two sides' logprobs, ratios and kl
    # part by that much; scaled by 1/64 (exact in bf16) the policy is
    # spread and a bf16 step of a logit is a few hundredths
    params = card.model.init_params(
        torch.Generator(device=dev).manual_seed(3), dev)
    if cfg.tie_embeddings:
        params["embed"]["embedding"].mul_(1 / 64)
    for w in (card, cpu):
        w.execute(api.make_op(spec, api.Op.INIT, params=params))
    del params
    batch = seeded_train_batch(
        lambda b: card.execute(api.make_op(spec, api.Op.FORWARD, b)),
        PARITY_B, s, s // 2, 4)
    out = {}
    for where, w in (("card", card), ("cpu", cpu)):
        out[where] = w.execute(api.make_op(spec, api.Op.UPDATE_ACTOR, batch))
        print(f"  {where} update_actor: {w.exec_log[-1][1]} s; {out[where]}")
    worst = 0.0
    for k in ("loss", "pg_loss", "kl", "aux", "grad_norm"):
        got, want = out["card"][k], out["cpu"][k]
        tol = 5e-2 * (want if k == "grad_norm" else max(1.0, abs(want)))
        worst = max(worst, abs(got - want) / tol)
        print(f"  {k}: card {got}, cpu {want}, |diff| {abs(got - want)}, "
              f"tolerance {tol}")
        if not abs(got - want) <= tol:
            fail(f"training parity {arch} {k}: {got} vs {want}")
    if not out["cpu"]["grad_norm"] > 0:
        fail(f"training parity {arch}: zero gradient")
    mu = {w: common.canonical_flat(x.opt_state().mu)
          for w, x in (("card", card), ("cpu", cpu))}
    for k, want in mu["cpu"].items():
        err = (mu["card"][k].cpu() - want).abs().max().item()
        tol = 5e-2 * want.abs().max().item()
        worst = max(worst, err / tol if tol else 0.0)
        if not err <= tol:
            fail(f"training parity {arch}: mu {k} max|diff| {err} > {tol}")
    print(f"  f32 mu of {len(mu['cpu'])} leaves within 5e-2 * max|mu| "
          f"(worst |diff| / tolerance over all checks {worst})")
    return worst


def train_parity_phase(torch, dev):
    """One update_actor on the card and on the CPU's plain path from the
    same parameters and batch, then K1's Function against autograd
    through the XLA-branch attention at the training shape."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import xla_attention

    update_parity(torch, dev, 9, ARCH,
                  (("num_layers", PARITY_LAYERS),) + TRAIN_OVERRIDES)
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


def ssm_parity_phase(torch, dev, records):
    """Phase 15: update_actor parity for mamba2 and zamba2, then K3's
    Function against plain autograd through ``ssd_chunked`` at the
    training shape, and K3's timing there."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.models.mamba2 import ssd_chunked

    update_parity(torch, dev, 15, SSM_ARCH,
                  (("num_layers", SSM_TRAIN_PARITY_LAYERS),))
    release(torch, dev, "mamba2 parity WPGs")
    update_parity(torch, dev, 15, HYB_ARCH,
                  (("num_layers", HYB_TRAIN_PARITY_LAYERS),),
                  s=HYB_TRAIN_PARITY_S)
    release(torch, dev, "zamba2 parity WPGs")

    b, s = TRAIN["batch_size"], TRAIN["seq_len"]
    h, p, n = SSM_H, SSM_HD, SSM_N
    gen = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    args = (randn(b, s, h, p), F.softplus(randn(b, s, h, dtype=torch.float32)),
            -torch.exp(randn(h, dtype=torch.float32)), randn(b, s, 1, n),
            randn(b, s, 1, n))
    ct = randn(b, s, h, p)
    print(f"phase 15: K3's Function vs autograd through ssd_chunked, B={b} "
          f"S={s} H={h} P={p} N={n} (one chunk of {s}), bf16 x, B, C")
    grads = {}
    for name, fn in (("function", lambda *a: ops.ssd(*a, chunk=SSM_CHUNK)),
                     ("ssd_chunked", lambda *a: ssd_chunked(
                         *a, min(SSM_CHUNK, s)))):
        leaves = [t.clone().requires_grad_() for t in args]
        before = ops.LAUNCHES["ssd"]
        fn(*leaves)[0].backward(ct)
        torch.cuda.synchronize()
        grew = ops.LAUNCHES["ssd"] - before
        if grew != (1 if name == "function" else 0):
            fail(f"{name} launched K3 {grew} times")
        grads[name] = [t.grad.float() for t in leaves]
    for name, got, want in zip(["x", "dt", "A", "B", "C"],
                               grads["function"], grads["ssd_chunked"]):
        err = (got - want).abs().max().item()
        tol = 5e-2 * want.abs().max().item()
        print(f"  d{name}: max|diff| {err}, tolerance {tol} (|expect| max "
              f"{want.abs().max().item()})")
        if not err <= tol:
            fail(f"K3's Function d{name} disagrees with ssd_chunked")
    print("  K3 launched once by the Function's forward, none by its "
          "backward")
    print("phase 15: K3 at the training shape")
    records["ssd"]["training"] = ssd_timing(torch, gen, dev, h, n,
                                            (("training", s),))


def ppo_phase(torch, dev, records):
    """Phase 16: a PPO job (actor and critic) and a GRPO job of qwen2-0.5b
    at full width on group 0, two steps each, through PlexCluster.run; a
    seeded PPO actor step; then OPTIM_STEP(host=True) against the device
    AdamW."""
    import numpy as np
    from repro_torch.core import api
    from repro_torch.core.cluster import PlexCluster
    from repro_torch.core.controller import JobConfig
    from repro_torch.core.state_manager import StateManager, Tier
    from repro_torch.core.worker import WorkerProcessGroup
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import MeshSlice
    from repro_torch.models import common
    from repro_torch.train import optimizer as opt

    n_new, steps = TRAIN["max_new_tokens"], TRAIN["steps"]
    print(f"phase 16: PPO (actor and critic) and GRPO jobs of {ARCH} at "
          f"full width cut to {PPO_LAYERS} layers on group 0 ({TRAIN}) "
          f"through PlexCluster.run")
    cluster = PlexCluster(n_groups=1)
    cut = (("num_layers", PPO_LAYERS),)
    ppo = cluster.add_job(JobConfig(job_id="ppo", model_name=ARCH, seed=1,
                                    overrides=cut, **TRAIN), algo="ppo")
    grpo = cluster.add_job(JobConfig(job_id="grpo", model_name=ARCH, seed=2,
                                     overrides=cut, **TRAIN))
    log = []
    for dep in (ppo.dep, ppo.critic, grpo.dep):
        counted(dep.wpg, dep.deployment_id, log)
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    billing = cluster.run(interleave=True)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    cfg = ppo.dep.wpg.cfg
    for dep_id, op, sec, grew in log:
        print(f"  {dep_id} {op}: {sec} s, launches {grew}")
        if grew != launches_per_op(cfg, op, n_new):
            fail(f"{dep_id} {op}: launches {grew}")
    want = step_launches(cfg, PPO_STEP + GRPO_STEP, n_new, steps)
    print(f"  {len(log)} ops in {wall} s; launches {launches}, want {want}; "
          f"peak card memory {torch.cuda.max_memory_allocated(dev)} B")
    if launches != want:
        fail(f"PPO + GRPO launches {launches}, want {want}")
    sm = cluster.router.state_managers[0]
    for dep in (ppo.dep, ppo.critic, grpo.dep):
        print(f"  {dep.deployment_id}: {sm.job_bytes(dep.wpg.job_prefix)} B")
    for sw in cluster.router.switch_log:
        print(f"  switch to {sw['to_job']}: offload {sw['t_offload']} s "
              f"{sw['offload_bytes']} B, load {sw['t_load']} s "
              f"{sw['load_bytes']} B")
    # PPO: 2 inits, then 8 ops a step (actor 5, critic 3); GRPO: 1 + 2
    for ctl, wpgs, submitted in (
            (ppo, [ppo.dep.wpg, ppo.critic.wpg], 2 + 8 * steps),
            (grpo, [grpo.dep.wpg], 1 + 2 * steps)):
        rec = billing[ctl.cfg.job_id]
        print(f"  bill {ctl.cfg.job_id}: busy {rec.busy_seconds} s, switch "
              f"{rec.switch_seconds} s, steps {rec.steps}, gpu-seconds a "
              f"step {rec.gpu_seconds_per_step()}")
        check_bill(cluster, rec, wpgs, submitted, steps)
    for i, m in enumerate(ppo.metrics_log):
        print(f"  ppo step {i}: {m}")
        if not {"pg_loss", "value_loss", "step"} <= m.keys() or not all(
                math.isfinite(v) for v in m.values()) or m["step"] != i + 1:
            fail(f"ppo step {i}: metrics {m}")
    if len(ppo.metrics_log) != steps:
        fail(f"ppo: {len(ppo.metrics_log)} steps recorded")
    actor = common.canonical_flat(ppo.dep.wpg.params())
    critic = common.canonical_flat(ppo.critic.wpg.params())
    differ = [k for k in actor if not torch.equal(actor[k].cpu(),
                                                  critic[k].cpu())]
    print(f"  the critic (synced actor + one value step) differs from the "
          f"actor in {len(differ)} of {len(actor)} leaves")
    if not differ:
        fail("the critic's value step changed nothing")
    records["flash_attention"]["ppo_launches"] = launches["flash_attention"]
    records["decode_attention"]["ppo_launches"] = launches["decode_attention"]

    # random weights earn no reward, so the steps above had zero
    # advantages: a seeded batch with token-level advantages gives the
    # actor a non-zero PPO gradient, and its step moves the moments
    router, dep = cluster.router, ppo.dep

    def done(fut):
        router.drain()
        return fut.result()

    batch = seeded_train_batch(lambda b: done(dep.forward(b)),
                               TRAIN["batch_size"], TRAIN["seq_len"],
                               TRAIN["prompt_len"], 4)
    rng = np.random.default_rng(4)
    batch["advantages"] = (rng.standard_normal(batch["loss_mask"].shape)
                           * batch["loss_mask"]).astype(np.float32)
    fb = done(dep.forward_backward(batch, objective="ppo"))
    pg = float(fb["metrics"]["pg_loss"])
    mu0 = moment_sums(dep.wpg)
    m = done(dep.optim_step(fb["grads"]))
    mu1 = moment_sums(dep.wpg)
    still = [k for k in mu1 if mu1[k] == mu0[k]]
    print(f"  seeded PPO actor step (B={TRAIN['batch_size']} "
          f"S={TRAIN['seq_len']}, token-level advantages): pg_loss {pg}, "
          f"{m}; f32 first moments changed in {len(mu1) - len(still)} of "
          f"{len(mu1)} leaves (unchanged: {still})")
    if not (math.isfinite(pg) and m["grad_norm"] > 0) \
            or set(still) - {"layers/attn/bk"}:
        fail("the seeded PPO actor step did not move the moments")
    del cluster, router, ppo, grpo, dep, actor, critic, fb
    release(torch, dev, "PPO cluster")

    # OPTIM_STEP(host=True) against the device AdamW with no clip, warmup
    # or weight decay, at lr 1e-2 (as tests/test_state_manager.py
    # configures it): a first Adam step moves each parameter by about lr,
    # several bf16 steps at the init's scale and 5x the tolerance
    cfg = opt.AdamWConfig(lr=1e-2, grad_clip=0.0, warmup_steps=0,
                          weight_decay=0.0)
    spec = api.DeploymentSpec(deployment_id="host-train", job_id="H",
                              model_name=ARCH, role="train")
    wpg = WorkerProcessGroup(spec, StateManager(mesh_slice=MeshSlice(0, dev)),
                             adamw_cfg=cfg)
    wpg.execute(api.make_op(spec, api.Op.INIT, 5))
    wpg.offload()                    # makes the pinned buffers
    wpg.ensure_resident()
    sm = wpg.sm
    hosts = {k: sm.entries[k].host for k in sm.keys_for(wpg.job_prefix,
                                                        "params")}
    moments = {k: sm.entries[k].ref for k in sm.keys_for(wpg.job_prefix,
                                                         "opt")}

    def clone(tree):
        return common.tree_map(torch.clone, tree, is_leaf=torch.is_tensor)

    p0 = clone(wpg.params())
    gen = torch.Generator(device=dev).manual_seed(7)
    grads = common.tree_map(
        lambda p: (torch.randn(p.shape, generator=gen, device=dev)
                   * 1e-2).to(p.dtype), p0, is_leaf=torch.is_tensor)
    out = wpg.execute(api.make_op(spec, api.Op.OPTIM_STEP, grads, host=True))
    host_s = wpg.exec_log[-1][1]
    same_buf = all(sm.entries[k].ref is h and sm.entries[k].tier == Tier.HOST
                   for k, h in hosts.items())
    in_place = all(sm.entries[k].ref is t and sm.entries[k].tier == Tier.DEVICE
                   for k, t in moments.items())
    dev_p = clone(p0)
    dev_st = opt.init(dev_p, cfg)
    opt.update_(grads, dev_st, dev_p, cfg)
    host_p = common.canonical_flat(wpg.params())
    host_st = wpg.opt_state()
    worst, moves, start = 0.0, [], common.canonical_flat(p0)
    for k, v in common.canonical_flat(dev_p).items():
        h = host_p[k].to(dev).float()
        worst = max(worst, (h - v.float()).abs().max().item())
        moves.append((h - start[k].float()).abs())
    moved = sum(bool(d.max() > 0) for d in moves)
    mean_move = (sum(d.sum().item() for d in moves)
                 / sum(d.numel() for d in moves))
    rel = {}
    for mom in ("mu", "nu"):
        want = common.canonical_flat(getattr(dev_st, mom))
        rel[mom] = max(((t - want[k]).abs().max()
                        / want[k].abs().max()).item()
                       for k, t in common.canonical_flat(
                           getattr(host_st, mom)).items())
    print(f"  OPTIM_STEP(host=True) on {ARCH} ({sm.job_bytes(wpg.job_prefix)}"
          f" B of state) at lr {cfg.lr}: {out}, {host_s} s; parameters on "
          f"the host in their pinned buffers: {same_buf}; moments updated "
          f"in place on the card: {in_place}; {moved} of {len(moves)} "
          f"parameter leaves moved, by {mean_move} on average; "
          f"max|host - device AdamW| {worst} (f32 tolerance 2e-3); moments' "
          f"max relative error {rel} (tolerance 1e-5)")
    if out != {"step": 1, "host": True} or not same_buf or not in_place \
            or moved != len(moves) or not worst <= 2e-3 \
            or not mean_move > cfg.lr / 2 or not max(rel.values()) <= 1e-5 \
            or (int(host_st.step), int(dev_st.step)) != (1, 1):
        fail("the host optimizer step disagrees with the device AdamW")


def checkpoint_phase(torch, dev, tmp):
    """Phase 17: a full-width qwen2-0.5b training job's state to DISK and
    back (and one host_capacity eviction), then checkpoint_all ->
    fail_node -> restore_all, each bit-exact on the card."""
    from repro_torch.core.cluster import PlexCluster
    from repro_torch.core.controller import JobConfig
    from repro_torch.core.state_manager import Tier

    print(f"phase 17: checkpoints and the DISK tier, a {ARCH} training job "
          f"at full width (one step of {CP_NEW} new tokens), files under "
          f"{tmp}")
    cluster = PlexCluster(n_groups=1)
    ctl = cluster.add_job(JobConfig(
        job_id="ck", model_name=ARCH, seed=4,
        **dict(TRAIN, steps=1, max_new_tokens=CP_NEW)))
    cluster.run()
    wpg = ctl.dep.wpg
    sm = wpg.sm
    sm.disk_dir = os.path.join(tmp, "disk")
    keys = sm.keys_for(wpg.job_prefix)
    nbytes = sm.job_bytes(wpg.job_prefix)
    kept = {k: sm.entries[k].ref.clone() for k in keys}

    def bit_exact():
        return all(sm.entries[k].tier == Tier.DEVICE
                   and torch.equal(sm.entries[k].ref, v)
                   for k, v in kept.items())

    t_off = wpg.offload(Tier.DISK)
    on_disk = sum(os.path.getsize(os.path.join(sm.disk_dir, f))
                  for f in os.listdir(sm.disk_dir))
    print(f"  DEVICE -> DISK: {nbytes} B in {t_off} s ({len(keys)} spill "
          f"files, {on_disk} B on disk); usage {sm.usage()}")
    t_load = wpg.ensure_resident()
    print(f"  DISK -> DEVICE: {nbytes} B in {t_load} s; bit-exact "
          f"{bit_exact()}; spill files left {os.listdir(sm.disk_dir)}")
    if not bit_exact() or sm.usage()["DISK"] or os.listdir(sm.disk_dir):
        fail("the DISK round trip changed the job's state")

    # one eviction: the job on the host, a capacity just below it
    wpg.offload()
    sm.host_capacity = sm.usage()["HOST"] - 1
    probe = sm.register("probe", {"x": torch.zeros(1, device=dev)})
    evicted = [k for k in keys if sm.entries[k].tier == Tier.DISK]
    print(f"  host_capacity {sm.host_capacity} B: registering an entry "
          f"evicted {evicted} to DISK; usage {sm.usage()}")
    if len(evicted) != 1 or sm.usage()["HOST"] > sm.host_capacity:
        fail(f"one eviction to DISK expected, got {evicted}")
    sm.unregister(probe)
    sm.host_capacity = float("inf")
    t_load = wpg.ensure_resident()
    print(f"  back to DEVICE in {t_load} s; bit-exact {bit_exact()}")
    if not bit_exact():
        fail("the eviction round trip changed the job's state")

    t0 = time.perf_counter()
    paths = cluster.checkpoint_all(os.path.join(tmp, "ckpt"))
    t_ck = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(p, f)) for p in paths.values()
               for f in os.listdir(p))
    params = {k: v for k, v in kept.items() if "/params/" in k}
    lost = cluster.fail_node(0)
    t0 = time.perf_counter()
    cluster.restore_all(paths)
    t_rs = time.perf_counter() - t0
    back = {k: sm.entries[k] for k in sm.keys_for(wpg.job_prefix, "params")}
    exact = back.keys() == params.keys() and all(
        e.tier == Tier.DEVICE and e.ref.device == dev
        and torch.equal(e.ref, params[k]) for k, e in back.items())
    print(f"  checkpoint_all: {paths} in {t_ck} s ({size} B on disk); "
          f"fail_node lost {len(lost)} entries; restore_all in {t_rs} s; "
          f"{len(back)} parameter leaves bit-exact on the card: {exact}")
    if not exact or len(lost) != len(keys):
        fail("checkpoint_all -> fail_node -> restore_all is not bit-exact")


def mem_used(torch, dev) -> int:
    """Bytes in use on the card, every process's (contexts included)."""
    free, total = torch.cuda.mem_get_info(dev)
    return total - free


def compute_apps() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return "; ".join(out.stdout.strip().splitlines()) or "none listed"


def same_bytes(torch, a, b) -> bool:
    a, b = (torch.as_tensor(x).reshape(-1).view(torch.uint8) for x in (a, b))
    return torch.equal(a, b)


def same_leaves(torch, a, b) -> bool:
    """Two flat {key: tensor or array} maps hold the same keys and bytes."""
    return a.keys() == b.keys() and all(
        same_bytes(torch, a[k], b[k]) for k in a)


def child_params(gp, dep):
    """A deployment's parameters as its child exports them for a sync."""
    from repro_torch.models import common
    return common.canonical_flat(gp.call("sync_export", {"dep": dep})[0])


def child_state(gp, prefix):
    """A job's managed state read from its child without moving it, by
    key: a ``migrate_export`` whose entries above 64 MiB spill to files
    (read here, then deleted), the rest inline. Prints the read's
    seconds."""
    import numpy as np

    t0 = time.perf_counter()
    payload, _ = gp.call("migrate_export",
                         {"job": prefix, "max_inline": 64 << 20})
    state = {e["key"]: e["data"] if e["path"] is None else np.load(e["path"])
             for e in payload["entries"]}
    for path in payload["spills"]:
        os.unlink(path)
    print(f"  read {payload['bytes']} B of {prefix} from group "
          f"{gp.group_id}'s child in {time.perf_counter() - t0} s")
    return state


def counted_in_child(wpg, job, log):
    """Wrap a WPGProxy's ``execute`` to log each op's job, name, seconds
    (its exec-log mirror), the kernel launches it made in the child (read
    there before and after) and the child's pid."""
    execute = wpg.execute

    def run(qop):
        before = wpg.gp.call("probe")[0]["launches"]
        out = execute(qop)
        after = wpg.gp.call("probe")[0]
        log.append((job, qop.op.value, wpg.exec_log[-1][1],
                    {k: after["launches"][k] - before[k] for k in before},
                    after["pid"]))
        return out

    wpg.execute = run


def proc_workload(process_plane: bool, steps: int = TRAIN["steps"]):
    """Phase 8's two GRPO jobs cut to phase 18's depth, A on group 0 and B
    on group 1, ``steps`` steps each."""
    from repro_torch.core.cluster import PlexCluster
    from repro_torch.core.controller import JobConfig

    cluster = PlexCluster(n_groups=2, process_plane=process_plane)
    ctls = {job: cluster.add_job(JobConfig(
        job_id=job, model_name=ARCH, seed=seed, overrides=PROC_OVERRIDES,
        **dict(TRAIN, steps=steps)), group_id=g)
        for g, (seed, job) in enumerate(((1, "A"), (2, "B")))}
    return cluster, ctls


def proc_phase(torch, dev, records, tmp):
    """Phase 18: the process plane. Phase 8's two jobs on two groups, each
    group's WPGs in a spawned child on the one card, then a cross-child
    weight sync, a live migration there and back, and a killed child
    respawned."""
    from repro_torch.core import api
    from repro_torch.kernels import ops
    from repro_torch.launch import shm_transport as shmt
    from repro_torch.launch.mesh import host_shm_bytes
    from repro_torch.launch.proc_plane import StateManagerProxy

    steps, n_new = PROC_STEPS, TRAIN["max_new_tokens"]
    cfg = proc_config()
    print(f"phase 18: the process plane, {ARCH} at full width, overrides "
          f"{dict(PROC_OVERRIDES)}, jobs A and B on groups 0 and 1 ({TRAIN}, "
          f"{steps} step(s) a job in process mode) through "
          f"PlexCluster.run(interleave=True, concurrent=True); card "
          f"{card_line()}; /dev/shm free {host_shm_bytes()} B; "
          f"shm_available() {shmt.shm_available()}")

    # the workload in thread mode first, one step a job: two dispatch
    # threads, one interpreter
    cluster, ctls = proc_workload(False, steps=1)
    ops.reset_launches()
    t0 = time.perf_counter()
    billing = cluster.run(interleave=True, concurrent=True)
    thread_wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    want = step_launches(cfg, GRPO_STEP, n_new, 2)
    print(f"  thread mode: {thread_wall} s for 2 jobs x 1 step; "
          f"launches {launches}")
    if launches != want:
        fail(f"thread mode launched {launches}, want {want}")
    for job, c in ctls.items():
        check_bill(cluster, billing[job], [c.dep.wpg], 1 + 2, 1)
    del cluster, ctls, c
    release(torch, dev, "thread-mode cluster")

    used0 = mem_used(torch, dev)
    parent0 = torch.cuda.memory_reserved(dev)
    cluster, ctls = proc_workload(True, steps=steps)
    router = cluster.router
    gps = router.group_procs
    print(f"  process mode: children {({g: gp.pid() for g, gp in gps.items()})}"
          f" (parent {os.getpid()}); routes "
          f"{({g: 'shm' if gp.shm_enabled else 'pickle' for g, gp in gps.items()})}")
    if len({gp.pid() for gp in gps.values()} | {os.getpid()}) != 3:
        fail("the groups do not run in two children of their own")
    log = []
    for job, c in ctls.items():
        counted_in_child(c.dep.wpg, job, log)
    for gp in gps.values():              # the children's counts, zeroed
        gp.call("probe", {"reset": True})
    ops.reset_launches()
    t0 = time.perf_counter()
    billing = cluster.run(interleave=True, concurrent=True)
    proc_wall = time.perf_counter() - t0
    want = step_launches(cfg, GRPO_STEP, n_new, 2 * steps)
    per_op = {op: launches_per_op(cfg, op, n_new)
              for op in ("init", "generate", "update_actor")}
    home = {"A": 0, "B": 1}
    for job, op, sec, grew, pid in log:
        print(f"  job {job} {op}: {sec} s in pid {pid}, launches {grew}")
        if grew != per_op[op]:
            fail(f"job {job} {op}: launches {grew}, want {per_op[op]}")
        if pid != gps[home[job]].pid():
            fail(f"job {job} {op} ran in pid {pid}")
    if any(ops.LAUNCHES.values()):
        fail(f"the parent launched kernels: {ops.LAUNCHES}")
    probes = {g: gp.call("probe")[0] for g, gp in gps.items()}
    child_launches = {k: sum(p["launches"][k] for p in probes.values())
                      for k in want}
    if child_launches != want:
        fail(f"the children launched {child_launches}, want {want}")
    for job, c in ctls.items():
        rec = billing[job]
        print(f"  bill {job}: busy {rec.busy_seconds} s, switch "
              f"{rec.switch_seconds} s, steps {rec.steps}")
        check_bill(cluster, rec, [c.dep.wpg], 1 + 2 * steps, steps)
        if not all(math.isfinite(v) for m in c.metrics_log
                   for v in m.values()):
            fail(f"job {job}: non-finite metrics {c.metrics_log}")
        del c.dep.wpg.execute            # the plain proxy from here on
    used1 = mem_used(torch, dev)
    child_reserved = sum(p["cuda_reserved"] or 0 for p in probes.values())
    ctx = (used1 - used0 - (torch.cuda.memory_reserved(dev) - parent0)
           - child_reserved) / 2
    print(f"  process mode: {proc_wall} s for 2 jobs x {steps} steps "
          f"(thread mode {thread_wall} s for 1 step); children's launches "
          f"{child_launches}; card memory in use {used0} -> {used1} B, the "
          f"children's caching allocators {child_reserved} B, so a child's "
          f"CUDA context ~{ctx} B; nvidia-smi: {compute_apps()}")
    for k in ("flash_attention", "decode_attention"):
        records[k]["process_plane_launches"] = child_launches[k]
    rtts = sorted(gps[0].ping(timeout=60) for _ in range(200))
    print(f"  IPC round trip (ping, group 0): median {rtts[100]} s, min "
          f"{rtts[0]} s, max {rtts[-1]} s over 200")

    # cross-child SYNC_WEIGHTS: job A's train deployment (group 0) into a
    # rollout deployment of job A on group 1
    d_roll = router.deploy(api.DeploymentSpec(
        deployment_id="A-rollout", job_id="A", model_name=ARCH,
        role="rollout", overrides=PROC_OVERRIDES), group_id=1)
    f = d_roll.init(seed=9)
    router.run_until_idle()
    f.result()
    want_params = child_params(gps[0], "A-train")
    if same_leaves(torch, child_params(gps[1], "A-rollout"), want_params):
        fail("the rollout deployment already held job A's parameters")
    f = ctls["A"].dep.sync_weights(d_roll)
    router.run_until_idle()
    f.result()
    sync_s = ctls["A"].dep.wpg.exec_log[-1][1]
    nbytes = sum(t.numel() * t.element_size() for t in want_params.values())
    exact = same_leaves(torch, child_params(gps[1], "A-rollout"),
                        want_params)
    print(f"  cross-child SYNC_WEIGHTS (group 0 -> group 1): {nbytes} B of "
          f"bf16 parameters in {sync_s} s ({nbytes / sync_s / 1e9} GB/s); "
          f"bit-exact {exact}")
    if not exact:
        fail("the cross-child weight sync is not bit-exact")
    router.teardown("A-rollout")
    del want_params

    # live migration of job B's train state: group 1 -> group 0 over shm,
    # then back through the spill tier for leaves above 64 MiB
    b_prefix = ctls["B"].dep.wpg.job_prefix
    nbytes = router.state_managers[1].job_bytes(b_prefix)
    free = host_shm_bytes()
    if free is None or free < nbytes:
        fail(f"/dev/shm has {free} B free, less than the {nbytes} B a move "
             f"of job B writes there")
    before = child_state(gps[1], b_prefix)
    moved = router.reassign_job("B", 0)
    lm = dict(router.state_managers[1].last_migrate)
    exact = same_leaves(torch, child_state(gps[0], b_prefix), before)
    print(f"  reassign_job(B, 0): {moved} B in {lm['seconds']} s "
          f"({moved / lm['seconds'] / 1e9} GB/s; export "
          f"{lm['export_seconds']} s, import {lm['import_seconds']} s), "
          f"{lm['keys']} entries, "
          f"{lm['spilled']} spilled, over shm {lm['shm']}; bit-exact {exact}")
    if not exact or moved != nbytes or not lm["shm"] or lm["spilled"]:
        fail("job B's move over shm was not whole and bit-exact")
    src = router.state_managers[0]
    src.migrate = functools.partial(StateManagerProxy.migrate, src,
                                    max_inline_bytes=64 << 20)
    try:
        moved = router.reassign_job("B", 1)
    finally:
        del src.migrate
    lm = dict(src.last_migrate)
    exact = same_leaves(torch, child_state(gps[1], b_prefix), before)
    left = glob.glob(os.path.join(gps[0].spill_dir(), "export__*"))
    rate = moved / lm["seconds"] / 1e9
    print(f"  back through StateManagerProxy.migrate(max_inline_bytes=64 "
          f"MiB): {moved} B in {lm['seconds']} s ({rate} GB/s; export "
          f"{lm['export_seconds']} s, import {lm['import_seconds']} s), "
          f"{lm['spilled']} of {lm['keys']} entries spilled to "
          f"disk, the rest over shm {lm['shm']}; bit-exact {exact}; spill "
          f"files left {left}")
    if not exact or moved != nbytes or not lm["spilled"] or left:
        fail("job B's move back through the spill tier was not whole and "
             "bit-exact")
    del before
    proc_kill(torch, dev, cluster, ctls, tmp, nbytes)

    procs = [gp._proc for gp in gps.values()]
    router.close_processes()
    left = [n for n in os.listdir("/dev/shm")
            if n.startswith(f"pxl{os.getpid()}g")]
    alive = [p.pid for p in procs if p.is_alive()]
    print(f"  close_processes: children alive {alive}, segments left {left}")
    if alive or left:
        fail("close_processes left a child or a segment")


def proc_kill(torch, dev, cluster, ctls, tmp, nbytes):
    """Phase 18's failure: SIGKILL group 1's child while job B's generate
    runs there, then respawn it and restore the job from the checkpoint
    its deployment saved through the op path."""
    from repro_torch.kernels import ops

    router = cluster.router
    gp = router.group_procs[1]
    dep = ctls["B"].dep
    path = os.path.join(tmp, "proc_ckpt_B")
    f = dep.save_checkpoint(path)
    router.run_until_idle()
    f.result()
    want_params = child_params(gp, "B-train")
    with cluster._bill_lock:
        cluster._bill_from_logs()
    billed, ran = cluster.billing["B"].busy_seconds, len(dep.wpg.exec_log)
    used_alive = mem_used(torch, dev)
    smi_alive = compute_apps()
    prompts = next(ctls["B"].batches)[0]
    router.serve()
    # four times the step's tokens: at 4 layers a 64-token generate lasts
    # some 0.4 s on a fast host, and the kill, 0.3 s into the channel's
    # hold, could land after it
    gen_f = dep.generate(prompts,
                         max_new_tokens=4 * TRAIN["max_new_tokens"])
    dep_f = dep.forward(gen_f)
    busy_since, deadline = None, time.monotonic() + 120
    while True:            # the channel held for 0.3 s: inside the generate
        if gp._lock.acquire(blocking=False):
            gp._lock.release()
            busy_since = None
        elif busy_since is None:
            busy_since = time.monotonic()
        elif time.monotonic() - busy_since > 0.3:
            break
        if gen_f.done() or time.monotonic() > deadline:
            fail("job B's generate was not caught running")
        time.sleep(0.01)
    pid = gp.pid()
    os.kill(pid, signal.SIGKILL)
    errors = []
    for fut in (gen_f, dep_f):
        try:
            fut.wait(timeout=120)
            errors.append(None)
        except RuntimeError as e:
            errors.append(str(e))
    router.shutdown()
    gp._proc.join(timeout=30)
    health = router.process_health()
    used_dead = mem_used(torch, dev)
    print(f"  SIGKILL pid {pid} (group 1) mid-generate: the op raised "
          f"{errors[0]!r}; its dependent {errors[1]!r}; health {health}; "
          f"card memory in use {used_alive} -> {used_dead} B "
          f"({used_alive - used_dead} B returned); nvidia-smi {smi_alive} "
          f"-> {compute_apps()}")
    if errors[0] is None or "group 1 worker process died" not in errors[0] \
            or "generate" not in errors[0]:
        fail("the killed generate did not fail naming its group")
    if errors[1] is None or "prerequisite" not in errors[1]:
        fail("the generate's dependent was not poisoned")
    if health != {0: True, 1: False}:
        fail(f"process_health {health}")
    if used_alive - used_dead < nbytes:
        fail("the dead child's card memory was not returned")
    with cluster._bill_lock:
        cluster._bill_from_logs()
    rec = cluster.billing["B"]
    logged = sum(dt for _, dt in dep.wpg.exec_log)
    print(f"  bill B: busy {billed} s before the kill, {rec.busy_seconds} s "
          f"after; {len(dep.wpg.exec_log)} ops logged ({ran} before)")
    if len(dep.wpg.exec_log) != ran or rec.busy_seconds != billed \
            or not math.isclose(rec.busy_seconds, logged):
        fail("the ops completed before the kill are not billed as they were")

    dead = f"pxl{os.getpid()}g1s{gp.spawn_count}c"
    t0 = time.perf_counter()
    respawned = router.respawn_dead_groups()
    gp.ping(timeout=120)
    t_respawn = time.perf_counter() - t0
    segs = [n for n in os.listdir("/dev/shm") if n.startswith(dead)]
    spills = glob.glob(os.path.join(gp.spill_dir(), "export__*"))
    used_new = mem_used(torch, dev)
    t0 = time.perf_counter()
    f_init = dep.init(seed=2)
    f_load = dep.load_checkpoint(path)
    router.run_until_idle()
    f_init.result()
    f_load.result()
    t_reload = time.perf_counter() - t0
    exact = same_leaves(torch, child_params(gp, "B-train"), want_params)
    probe = gp.call("probe", {"reset": True})[0]
    ctx = mem_used(torch, dev) - used_new - (probe["cuda_reserved"] or 0)
    t0 = time.perf_counter()
    tails = ctls["B"].submit_step()
    router.run_until_idle()
    metrics = [t.result() for t in tails]
    t_step = time.perf_counter() - t0
    grew = gp.call("probe")[0]["launches"]
    step_want = step_launches(proc_config(), GRPO_STEP,
                              TRAIN["max_new_tokens"])
    print(f"  respawn_dead_groups() {respawned}: {t_respawn} s (spawn, "
          f"handshake, deployment replay; new pid {gp.pid()}); segments of "
          f"{dead} left {segs}, spill files left {spills}; INIT + "
          f"LOAD_CHECKPOINT {t_reload} s (CUDA init, the parameters), "
          f"parameters bit-exact {exact}; the new child's CUDA context "
          f"~{ctx} B; one more step {t_step} s, metrics {metrics}, "
          f"launches {grew}")
    if respawned != [1] or segs or spills or not exact:
        fail("the respawn left residue or the checkpoint did not restore")
    if grew != step_want or not all(math.isfinite(v) for m in metrics
                                    for v in m.values()):
        fail(f"the step after the restore: launches {grew}, want "
             f"{step_want}; metrics {metrics}")
    if any(ops.LAUNCHES.values()):
        fail(f"the parent launched kernels: {ops.LAUNCHES}")


def proc_config():
    from repro_torch.configs import get_config
    return get_config(ARCH).replace(**dict(PROC_OVERRIDES))


def pinned_train_phase(torch, dev, records, phase, arch, layers):
    """Phase 8's two GRPO jobs of ``arch`` at full width cut to ``layers``
    layers, once the card and the pinned host memory of earlier phases are
    released: phase 14 (mamba2-2.7b) and 21 (granite-moe-3b-a800m). Fails
    unless the host can pin both jobs' train state, every switch moves a
    whole job and the kernels' launches over the four steps are exactly
    those of ``launches_per_op``."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    overrides = (("num_layers", layers),)
    cfg = get_config(arch).replace(**dict(overrides))
    n = build_model(cfg).param_count()
    # the parameters (bf16, but the f32 leaves: mamba2's A_log, D and
    # dt_bias, the MoE router), f32 mu and nu, the int32 step
    state = spec_bytes(cfg) + 2 * 4 * n + 4
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            mem[key] = int(val.split()[0]) * 1024
    print(f"phase {phase}: {arch} training needs {state} B of train state "
          f"a job, pinned on the host for two jobs: {2 * state} B; MemTotal "
          f"{mem['MemTotal']} B, MemAvailable {mem.get('MemAvailable')} B")
    if mem.get("MemAvailable", mem["MemTotal"]) < 2 * state:
        fail(f"the host cannot pin two {arch} jobs' train state "
             f"({2 * state} B)")
    cluster = train_phase(torch, dev, records, phase, arch, overrides)
    sm = cluster.router.state_managers[0]
    held = {c.cfg.job_id: sm.job_bytes(c.dep.wpg.job_prefix)
            for c in cluster.controllers.values()}
    if set(held.values()) != {state}:
        fail(f"the jobs hold {held} B, want {state} B each")
    want = step_launches(cfg, GRPO_STEP, TRAIN["max_new_tokens"],
                         2 * TRAIN["steps"])
    got = {k: records[k].get("train_launches", {}).get(arch, {}).get(
        "total", 0) for k in want}
    print(f"  launches over the {2 * TRAIN['steps']} steps: {got}")
    if got != want:
        fail(f"launches over the steps {got}, want {want}")
    return cluster


# ------------------------------------- phases 12, 13: the cluster

# the ops of one step of each algorithm, in the order the controllers
# submit them
GRPO_STEP = ("generate", "update_actor")
PPO_STEP = ("generate", "forward", "forward", "forward_backward",
            "optim_step", "sync_weights", "forward_backward", "optim_step")


def step_launches(cfg, ops, n_new, steps=1):
    """The kernel launches of ``steps`` steps made of ``ops``."""
    per_op = [launches_per_op(cfg, op, n_new) for op in ops]
    return {k: steps * sum(p[k] for p in per_op) for k in per_op[0]}


def train_launches_want(steps, n_new, layers=LAYERS):
    """Launches of ``steps`` GRPO steps of ARCH at full width and
    ``layers`` deep: K1 in each generate's prefill and each update_actor's
    forward, K2 in each decode step."""
    from repro_torch.configs import get_config
    return step_launches(get_config(ARCH).replace(num_layers=layers),
                         GRPO_STEP, n_new, steps)


def train_cli_phase(records, tmp):
    """``python -m repro_torch.launch.train`` at full width and
    TRAIN_CLI_LAYERS deep in a child process on its default device, checkpointing under ``tmp`` after the
    run. The child runs the module as ``-m`` does (runpy) between zeroing
    and printing the kernels' launch counts."""
    ckpt_dir = os.path.join(tmp, "launch_train")
    argv = TRAIN_CLI + ["--ckpt-dir", ckpt_dir]
    print(f"phase 12: python -m repro_torch.launch.train {' '.join(argv)} "
          f"(a child process, its default device)")
    code = "\n".join([
        "import json, runpy, sys",
        "from repro_torch.kernels import ops",
        f"sys.argv = ['repro_torch.launch.train'] + {argv!r}",
        "ops.reset_launches()",
        "runpy.run_module('repro_torch.launch.train', run_name='__main__',",
        "                 alter_sys=True)",
        "print('launches ' + json.dumps(ops.LAUNCHES))"])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    wall = time.monotonic() - t0
    for line in proc.stdout.splitlines():
        print(f"  {line}")
    if proc.returncode != 0:
        fail(f"launch.train exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    for job in ("job0", "job1"):
        steps = [ln for ln in lines if ln.startswith(f"[{job}] steps=")]
        loss = [ln for ln in lines if ln.startswith(f"[{job}] loss first=")]
        if not steps or steps[0].split()[1] != "steps=2":
            fail(f"{job} did not print 2 steps")
        first, last = (float(loss[0].split()[i].split("=")[1])
                       for i in (2, 3))
        if not (math.isfinite(first) and math.isfinite(last)):
            fail(f"{job}: loss {first}, {last}")
    tail = next(ln for ln in lines if ln.startswith("wall=")).split()
    switches = int(tail[1].split("=")[1])
    if switches < 3 or tail[2] != "device=cuda:0":
        fail(f"launch.train: {' '.join(tail)}")
    launches = json.loads(lines[-1].split(" ", 1)[1])
    want = train_launches_want(4, 64, TRAIN_CLI_LAYERS)
    print(f"  child process {wall} s; launches {launches}, want {want}")
    if launches != want:
        fail(f"launch.train launches {launches}, want {want}")
    for k in ("flash_attention", "decode_attention"):
        records[k]["cluster_launches"] = launches[k]
    # what --ckpt-dir wrote after the run
    written = {}
    for dep in sorted(os.listdir(ckpt_dir)):
        path = os.path.join(ckpt_dir, dep)
        written[dep] = {f: os.path.getsize(os.path.join(path, f))
                        for f in sorted(os.listdir(path))}
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        print(f"  {path}: {written[dep]}; {len(meta['tensors'])} tensors, "
              f"step {meta['step']}, job {meta['job_id']}")
    if sorted(written) != ["job0-train", "job1-train"]:
        fail(f"--ckpt-dir wrote {written}")


def control_plane_phase(torch, dev, records):
    """The reference's serve auto-placement flow
    (tests/test_control_plane.py::test_serve_auto_placement_end_to_end) at
    full width and depth on the card, then the release of a removed
    job's bytes."""
    from repro_torch.core.cluster import PlexCluster
    from repro_torch.core.control_plane import DirectorConfig
    from repro_torch.core.controller import JobConfig
    from repro_torch.kernels import ops

    print(f"phase 13: the control plane live, {ARCH} at full width and "
          f"depth, jobs {CP_STEPS} (steps) added with group_id=None, "
          f"{CP_NEW} new tokens a step")
    c = PlexCluster(n_groups=1, director_cfg=DirectorConfig(
        horizon=240.0, cold_reserve_s=30.0, min_groups=1))
    router = c.router
    moves = []
    migrate_job = router.migrate_job

    def f32_entries(job, group):
        sm = router.state_managers[group]
        pre = f"{job}:{job}-train/"
        return {k: e.ref for k, e in sm.entries.items()
                if k.startswith(pre) and e.ref.dtype == torch.float32}

    def traced_migrate(job, src, dst):
        # the job is held and quiesced here: no op runs between the reads
        before = {k: v.clone() for k, v in f32_entries(job, src).items()}
        ptrs = {k: v.data_ptr() for k, v in f32_entries(job, src).items()}
        moved = migrate_job(job, src, dst)
        after = f32_entries(job, dst)
        moves.append(dict(
            router.migrate_log[-1], f32_leaves=len(before),
            bit_exact=before.keys() == after.keys() and all(
                torch.equal(v, after[k]) for k, v in before.items()),
            same_storage=all(after[k].data_ptr() == p
                             for k, p in ptrs.items())))
        return moved

    router.migrate_job = traced_migrate

    def cfg(job, seed):
        return JobConfig(job_id=job, model_name=ARCH, seed=seed,
                         overrides=TRAIN_OVERRIDES,
                         **dict(TRAIN, max_new_tokens=CP_NEW,
                                steps=CP_STEPS[job]))

    def kinds():
        return [e["event"] for e in c.director.events]

    def wait(done, what):
        deadline = time.monotonic() + 300
        while not done():
            if c.client_errors or time.monotonic() > deadline:
                fail(f"{what}; client errors {c.client_errors}; director "
                     f"events {c.director.events}")
            time.sleep(0.05)

    ops.reset_launches()
    t0 = time.perf_counter()
    with c.serve():
        c.add_job(cfg("auto-a", 1), group_id=None)
        c.add_job(cfg("auto-b", 2), group_id=None)
        wait(lambda: all(c.director.job_state(j).phase == "warm"
                         for j in ("auto-a", "auto-b")), "no warm promotion")
        ga, gb = (c.director.job_state(j).group_id
                  for j in ("auto-a", "auto-b"))
        if ga != gb:
            fail(f"warm jobs on groups {ga} and {gb}: {c.director.events}")
        wait(lambda: "retire_group" in kinds(),
             "the profiling group never retired")
        spawns = kinds().count("spawn_group")
        c.add_job(cfg("auto-c", 3), group_id=None)
        gc_ = c.director.job_state("auto-c").group_id
        if kinds().count("spawn_group") != spawns + 1 or gc_ == ga:
            fail(f"auto-c on group {gc_} without a spawn: "
                 f"{c.director.events}")
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for e in c.director.events:
        print(f"  director: {e}")
    for m in moves:
        print(f"  migration: {m}")
    print(f"  {wall} s in serve(); launches {launches}")
    job_bytes = {}
    for job, steps in CP_STEPS.items():
        ctl, rec = c.controllers[job], c.billing[job]
        wpg = ctl.dep.wpg
        job_bytes[job] = wpg.sm.job_bytes(wpg.job_prefix)
        logged = sum(dt for _, dt in wpg.exec_log)
        group = router.group_of[ctl.dep.deployment_id]
        print(f"  bill {job}: busy {rec.busy_seconds} s (exec log "
              f"{logged} s), switch {rec.switch_seconds} s, steps "
              f"{rec.steps}, gpu-seconds a step {rec.gpu_seconds_per_step()}"
              f"; {job_bytes[job]} B on group {group}")
        if ctl.steps_completed != steps or rec.steps != steps or \
                not math.isclose(rec.busy_seconds, logged):
            fail(f"{job}: {ctl.steps_completed} steps, bill {rec}")
        if not all(math.isfinite(m["loss"]) for m in ctl.metrics_log):
            fail(f"{job}: non-finite loss")
    if not any(m["bytes"] == job_bytes[m["job"]] and not m["cross_mesh"]
               and m["bit_exact"] for m in moves):
        fail(f"no live migration of a whole job: {moves}")
    want = train_launches_want(sum(CP_STEPS.values()), CP_NEW)
    if launches != want:
        fail(f"control-plane launches {launches}, want {want}")
    for k in ("flash_attention", "decode_attention"):
        records[k]["control_plane_launches"] = launches[k]

    # every entry of auto-c on the card, wherever the last switch left it
    wpg = c.controllers["auto-c"].dep.wpg
    wpg.ensure_resident()
    gc.collect()
    before = torch.cuda.memory_allocated(dev)
    c.remove_job("auto-c")
    del wpg
    gc.collect()
    drop = before - torch.cuda.memory_allocated(dev)
    print(f"  remove_job(auto-c): card memory allocated fell by {drop} B; "
          f"the job held {job_bytes['auto-c']} B")
    if abs(drop - job_bytes["auto-c"]) > MEM_TOL:
        fail(f"remove_job released {drop} B of {job_bytes['auto-c']} B")


# ------------------------------------------- phases 19, 20: the MoE

def moe_serve_phase(torch, dev, records):
    """Phase 19: one Qwen3-30B-A3B job at full width, cut to MOE_LAYERS
    layers, through Router -> HRRS -> WPG -> rollout: INIT, then MOE_ROUNDS batched
    generates, the last under the profiler, each with exactly MOE_LAYERS K1
    and MOE_LAYERS * N_NEW K2 launches (the counts set to 0 before each);
    the prefill's capacity drops are counted on the card. Round 0 reads
    MathDataset's prompts, ~92 % PAD at this length, whose PADs route
    alike and overflow the capacity; the profiled round's prompts fill all
    MOE_P tokens with seeded ids over the vocabulary."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.core.router import Router
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    from repro_torch.rl import data as data_lib

    overrides = (("num_layers", MOE_LAYERS),)
    cfg = get_config(MOE_ARCH).replace(**dict(overrides))
    model = build_model(cfg)
    want_bytes = spec_bytes(cfg)
    want = {"flash_attention": MOE_LAYERS,
            "decode_attention": MOE_LAYERS * N_NEW, "ssd": 0}
    cap = moe.expert_capacity(cfg, MOE_P)
    print(f"phase 19: serving {MOE_ARCH} at full width cut to {MOE_LAYERS} "
          f"layers, one job (B={B}, prompt {MOE_P}, {N_NEW} new, temperature 0.7; "
          f"{model.param_count()} parameters, {model.active_param_count()} "
          f"active; the prefill's capacity {cap} a row and expert)")
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    router = Router()                 # the CUDA devices; one card here
    dep = router.deploy(api.DeploymentSpec(
        deployment_id="rollout-moe", job_id="M", model_name=MOE_ARCH,
        role="rollout", overrides=overrides), group_id=0)
    rng = np.random.default_rng(0)
    padded = next(data_lib.MathDataset(seed=0).batches(B, MOE_P))[0]
    prompt_sets = [("MathDataset", padded) if r == 0 else
                   ("seeded ids", rng.integers(data_lib.EOS + 1,
                                               cfg.vocab_size,
                                               size=(B, MOE_P),
                                               dtype=np.int32))
                   for r in range(MOE_ROUNDS)]
    # each prefill layer's (dropped choices, choices), summed on the card
    drops = []
    slot_ranks = moe.slot_ranks

    def counting(expert_ids, e):
        pos = slot_ranks(expert_ids, e)
        if expert_ids.shape[1] > 1:
            drops.append(((pos >= cap).sum(), expert_ids.numel()))
        return pos

    with router:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        dep.init(seed=1).wait(timeout=900)
        t_init = time.perf_counter() - t0
        nbytes = router.state_managers[0].job_bytes(dep.wpg.job_prefix)
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"  INIT: {t_init} s; parameter bytes on the card {nbytes} "
              f"(want {want_bytes}); peak card memory through the init "
              f"{peak} B of {card_bytes} B")
        if nbytes != want_bytes or peak >= 80e9:
            fail(f"INIT holds {nbytes} B at a peak of {peak} B")
        moe.slot_ranks = counting
        try:
            for r, (kind, prompts) in enumerate(prompt_sets):

                def run():
                    return dep.generate(prompts, max_new_tokens=N_NEW,
                                        temperature=0.7).wait(timeout=600)

                drops.clear()
                torch.cuda.reset_peak_memory_stats(dev)
                ops.reset_launches()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                if r == MOE_ROUNDS - 1:
                    out, busy = profile_round(torch, run)
                else:
                    out, busy = run(), None
                wall = time.perf_counter() - t0
                end.record()
                end.synchronize()
                launches = dict(ops.LAUNCHES)
                peak = torch.cuda.max_memory_allocated(dev)
                toks, logps = out["tokens"], out["logprobs"]
                if tuple(toks.shape) != (B, N_NEW) or \
                        not bool(((toks >= 0) & (toks < cfg.vocab_size))
                                 .all()) or \
                        not bool(torch.isfinite(logps).all()):
                    fail(f"round {r}: tokens {tuple(toks.shape)} or "
                         f"logprobs out of range")
                if launches != want:
                    fail(f"round {r}: launches {launches}, want {want}")
                if peak >= 80e9:
                    fail(f"round {r}: peak card memory {peak} B")
                dropped = sum(int(d) for d, _ in drops)
                choices = sum(c for _, c in drops)
                print(f"  generate {r}: wall {wall * 1e3} ms, device span "
                      f"{start.elapsed_time(end)} ms (events), device busy "
                      + (f"{busy * 1e3} ms (profiler)" if busy is not None
                         else "not measured (unprofiled round)")
                      + f"; {B * N_NEW / wall} tok/s; launches {launches}; "
                      f"peak card memory {peak} B; the prefill dropped "
                      f"{dropped} of {choices} (token, expert) choices in "
                      f"{len(drops)} layers ({kind} prompts)")
                if len(drops) != MOE_LAYERS:
                    fail(f"round {r}: {len(drops)} prefill MoE layers")
        finally:
            moe.slot_ranks = slot_ranks
    path_launches(records, launches, want, "qwen3_moe")
    return router


class RouteReplay:
    """The MoE routing of one run replayed by another (phase 20: the card's
    by the CPU; phase 33: a slice's by one device): :meth:`recording`
    wraps ``moe.route`` to keep each call's f32 router logits and expert
    ids; :meth:`replaying` has the next run's calls, in the same order,
    take the recorded ids with gates from their own logits, so both runs
    compute one function. :meth:`check` fails unless every flip (the
    replaying run's own choice against the recorded one) is a near-tie of
    the router's logits and, where ``share`` is given, they stay under
    that share of the choices; where ``logit_tol`` is given, unless the two
    runs' router logits agree within ``logit_tol`` * max|logit| (a routing
    fault moves them by the logits' own scale, and would make every flip
    look like a near-tie)."""

    def __init__(self, phase, label):
        self.phase, self.label = phase, label
        self.calls, self.own = [], []

    @contextlib.contextmanager
    def _wrapped(self, fn):
        from repro_torch.models import moe

        route = moe.route
        moe.route = functools.partial(fn, route)
        try:
            yield
        finally:
            moe.route = route

    def recording(self, n=1):
        """Records the calls of a run on ``n`` devices: each of them
        routes every MoE call alike, in device order, so the first
        device's call stands for the slice's."""
        seen = [0]

        def rec(route, router, cfg, x, logits=None):
            out = route(router, cfg, x, logits)
            seen[0] += 1
            if (seen[0] - 1) % n == 0:
                self.calls.append((logits if logits is not None
                                   else x.float() @ router, out[1]))
            return out

        return self._wrapped(rec)

    def replaying(self):
        import torch

        def rep(route, router, cfg, x, logits=None):
            _, ids, aux = route(router, cfg, x, logits)
            lg = x.float() @ router
            self.own.append((lg.detach(), ids))
            i = len(self.own) - 1
            if i >= len(self.calls) or self.calls[i][1].shape != ids.shape:
                fail(f"phase {self.phase}: {self.label}: the replaying "
                     f"run's MoE calls differ from the recorded run's")
            ids = self.calls[i][1].to(ids.device)
            gate_w = torch.gather(torch.softmax(lg, dim=-1), -1, ids)
            gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True),
                                          min=1e-9)
            return gate_w, ids, aux

        return self._wrapped(rep)

    def check(self, k, share=MOE_FLIP_SHARE, logit_tol=None):
        import torch

        flips = choices = 0
        gaps = []
        diff = top_abs = 0.0
        for (ls, ids_s), (lo, ids_o) in zip(self.calls, self.own):
            ls, ids_s = ls.detach().to(lo.device), ids_s.to(lo.device)
            diff = max(diff, (ls - lo).abs().max().item())
            top_abs = max(top_abs, lo.abs().max().item())
            lost = ~(ids_s[..., :, None] == ids_o[..., None, :]).any(-1)
            flips += int(lost.sum())
            choices += lost.numel()
            tok = lost.any(-1)
            top = torch.sort(lo, -1, descending=True)[0]
            gap = (top[..., k - 1] - top[..., k])[tok]
            noise = (ls - lo).abs().amax(-1)[tok]
            gaps += list(zip(gap.tolist(), (2 * noise).tolist()))
        print(f"  {self.label}: routing flips: {flips} "
              f"of {choices} choices in {len(self.calls)} MoE calls (limit "
              f"{share} of them); (gap, 2 x router-logit "
              f"difference) at each {gaps}")
        print(f"  {self.label}: router logits: max|diff| {diff}, max|logit| "
              f"{top_abs} (limit {logit_tol} of it)")
        if len(self.own) != len(self.calls) or \
                (share is not None and flips > share * choices) or \
                any(g > t for g, t in gaps):
            fail(f"phase {self.phase}: {self.label}: {flips} routing flips "
                 f"of {choices}, or one not at a near-tie")
        if logit_tol is not None and not diff <= logit_tol * top_abs:
            fail(f"phase {self.phase}: {self.label}: router logits apart by "
                 f"{diff}, over {logit_tol} * {top_abs}")


def moe_parity_phase(torch, dev):
    """Phase 20: card vs CPU for Qwen3-30B-A3B at full width cut to
    MOE_PARITY_LAYERS layers, as phase 5 (MathDataset prompts, teacher-
    forced decode). Each MoE layer's router logits and choices are
    recorded on the card, and the CPU side then replays the card's expert
    ids, with its own gates over them (:class:`RouteReplay`), so both
    compute one function and every position's logits are held within
    phase 5's tolerance. The two sides may choose differently where the
    f32 router's k-th and (k+1)-th logits nearly tie: fails unless every
    such (token, layer, slot) flip is one (the CPU's gap within twice the
    token's card-vs-CPU router-logit difference) and the flips stay under
    MOE_FLIP_SHARE of the choices."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config(MOE_ARCH).replace(num_layers=MOE_PARITY_LAYERS)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(1),
                               dev)
    b, p, n = MOE_PARITY_B, 64, 8
    prompt, forced = parity_prompt(torch, cfg, b, p, n)
    rel_tol = 2.0 ** -6 * math.sqrt(cfg.num_layers / 4)
    print(f"phase 20: parity card vs CPU plain, {MOE_ARCH} at full width "
          f"cut to {cfg.num_layers} layers, B={b} P={p}, {n} teacher-forced "
          f"decode steps, the CPU replaying the card's expert ids "
          f"(tolerance {rel_tol} * max|logit|)")
    replay, logits = RouteReplay(20, "card vs CPU"), {}
    for where, d, wrap in (("card", dev, replay.recording),
                           ("cpu", torch.device("cpu"), replay.replaying)):
        with wrap():
            logits[where] = side_logits(torch, model, params, d, prompt,
                                        forced, where)[0]
    del params
    for i, (gpu, cpu) in enumerate(zip(logits["card"], logits["cpu"])):
        err = (gpu - cpu).abs().max().item()
        tol = rel_tol * cpu.abs().max().item()
        agree = (gpu.argmax(-1) == cpu.argmax(-1)).float().mean().item()
        label = "prefill" if i == 0 else f"decode {i}"
        print(f"  {label}: max|diff| {err}, tolerance {tol}, argmax "
              f"agreement {agree}")
        if not (torch.isfinite(gpu).all() and err <= tol):
            fail(f"parity {label}: {err} > {tol}")
    replay.check(cfg.experts_per_token)


# ------------------------------------------ phases 23, 24: gemma2

def gemma2_serve_phase(torch, dev, records):
    """Phase 23: one gemma2-27b job at full width, cut to GEMMA_LAYERS
    layers, through Router -> HRRS -> WPG -> rollout: INIT, then GEMMA_ROUNDS generates at
    B=16 prompt GEMMA_P (the last under the profiler) and one at B=1 prompt
    GEMMA_LONG_P, where the local layers' window cuts in K1's prefill and
    in every K2 step; each with exactly GEMMA_LAYERS K1 and GEMMA_LAYERS *
    N_NEW K2 launches (the counts set to 0 before each) and a peak under
    80 GB. The prompts are seeded ids over the vocabulary."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.core.router import Router
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.rl import data as data_lib

    overrides = (("num_layers", GEMMA_LAYERS),)
    cfg = get_config(GEMMA_ARCH).replace(**dict(overrides))
    model = build_model(cfg)
    want_bytes = spec_bytes(cfg)
    want = {"flash_attention": GEMMA_LAYERS,
            "decode_attention": GEMMA_LAYERS * N_NEW, "ssd": 0}
    print(f"phase 23: serving {GEMMA_ARCH} at full width cut to "
          f"{GEMMA_LAYERS} layers, one job ({model.param_count()} parameters; {GEMMA_ROUNDS} rounds at "
          f"B={B} prompt {GEMMA_P}, then B=1 prompt {GEMMA_LONG_P}; {N_NEW} "
          f"new, temperature 0.7)")
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    router = Router()                 # the CUDA devices; one card here
    dep = router.deploy(api.DeploymentSpec(
        deployment_id="rollout-gemma2", job_id="G", model_name=GEMMA_ARCH,
        role="rollout", overrides=overrides), group_id=0)
    rng = np.random.default_rng(0)
    rounds = [(B, GEMMA_P, r == GEMMA_ROUNDS - 1)
              for r in range(GEMMA_ROUNDS)] + [(1, GEMMA_LONG_P, False)]
    with router:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        dep.init(seed=1).wait(timeout=900)
        t_init = time.perf_counter() - t0
        nbytes = router.state_managers[0].job_bytes(dep.wpg.job_prefix)
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"  INIT: {t_init} s; parameter bytes on the card {nbytes} "
              f"(want {want_bytes}); peak card memory through the init "
              f"{peak} B of {card_bytes} B")
        if nbytes != want_bytes or peak >= 80e9:
            fail(f"INIT holds {nbytes} B at a peak of {peak} B")
        for r, (b, p, profiled) in enumerate(rounds):
            prompts = rng.integers(data_lib.EOS + 1, cfg.vocab_size,
                                   size=(b, p), dtype=np.int32)

            def run():
                return dep.generate(prompts, max_new_tokens=N_NEW,
                                    temperature=0.7).wait(timeout=600)

            torch.cuda.reset_peak_memory_stats(dev)
            ops.reset_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            out, busy = profile_round(torch, run) if profiled else \
                (run(), None)
            wall = time.perf_counter() - t0
            end.record()
            end.synchronize()
            launches = dict(ops.LAUNCHES)
            peak = torch.cuda.max_memory_allocated(dev)
            toks, logps = out["tokens"], out["logprobs"]
            if tuple(toks.shape) != (b, N_NEW) or \
                    not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()) \
                    or not bool(torch.isfinite(logps).all()):
                fail(f"round {r}: tokens {tuple(toks.shape)} or logprobs "
                     f"out of range")
            if launches != want:
                fail(f"round {r}: launches {launches}, want {want}")
            if peak >= 80e9:
                fail(f"round {r}: peak card memory {peak} B")
            print(f"  generate {r} (B={b}, prompt {p}): wall {wall * 1e3} ms, "
                  f"device span {start.elapsed_time(end)} ms (events), "
                  f"device busy "
                  + (f"{busy * 1e3} ms (profiler)" if busy is not None
                     else "not measured (unprofiled round)")
                  + f"; {b * N_NEW / wall} tok/s; launches {launches}; peak "
                  f"card memory {peak} B")
            k1, k2 = ("gemma2", "gemma2_local") if b == B else \
                ("gemma2_long_local", "gemma2_long_local")
            path_launches(records, launches, {"flash_attention": 1}, k1)
            path_launches(records, launches, {"decode_attention": 1}, k2)
    return router


def gemma2_parity_phase(torch, dev):
    """Phase 24: card vs CPU for gemma2-27b at full width cut to one pair
    of layers (local, then global), as phase 5 at B=2 prompt 128 with 8
    decode steps; then at B=1 prompt 4352, where the window cuts in the
    prefill and in the 2 decode steps after it: on the CPU when the first
    check's CPU side predicts at most GEMMA_CPU_LONG_S seconds for it,
    else against the card's plain attention (``plain_attention``).

    Both sides leave out the final logit softcap: phase 5's bound is four
    bf16 steps of the largest logit, and the logits that are a bf16
    product are those before the cap. At the seeded init the largest is a
    token's own logit under the tied embedding (about 4,670: a squared row
    norm of 4608 units), and the cap squeezes every logit into +-30, so
    max|logit| after it no longer measures their bf16 steps: the capped
    prefill logits part by 0.337 against a bound of 0.331 so computed, at
    a logit of -4.2 (PERF.md). The capped logits' differences are printed
    beside that bound. The cap is f32 code shared by both sides, held
    against the JAX package on the CPU (tests/test_torch_gemma2.py);
    everything before it, K1 and K2 included, is held here."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config(GEMMA_ARCH)
    cap = cfg.final_logit_softcap
    model = build_model(cfg.replace(num_layers=GEMMA_PARITY_LAYERS,
                                    final_logit_softcap=None))
    params = model.init_params(torch.Generator(device=dev).manual_seed(1),
                               dev)
    _, seconds = parity_phase(torch, model, params, dev, 24,
                              b=GEMMA_PARITY_B, p=GEMMA_P, n=8,
                              cap=cap)
    # the long prefill's tokens over the first check's (its matmuls
    # scale with them; the decode steps' weight reads make the estimate
    # high)
    predicted = seconds["cpu"] * GEMMA_LONG_P / (GEMMA_PARITY_B * GEMMA_P)
    against = "cpu" if predicted <= GEMMA_CPU_LONG_S else "card plain"
    print(f"phase 24: the long check's CPU side predicted at {predicted} s "
          f"(limit {GEMMA_CPU_LONG_S} s): against {against}")
    parity_phase(torch, model, params, dev, 24, b=1, p=GEMMA_LONG_P, n=2,
                 against=against, cap=cap)


def whisper_frames(torch, dev, b, seed):
    """Stub frame embeddings (B, 1500, d_model) bf16 at the reference's
    ``dummy_batch`` scale, drawn from a seeded generator on ``dev``."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, WHISPER_T, get_config(WHISPER_ARCH).d_model)
    return (WHISPER_FRAME_SCALE * torch.randn(
        shape, generator=gen, device=dev)).to(torch.bfloat16)


def whisper_serve_phase(torch, dev, records):
    """Phase 25: ``serve_phase`` for two whisper-large-v3 jobs at full
    width, cut to WHISPER_LAYERS encoder and decoder layers, each generate
    given its own bf16 frames through ``extra_inputs`` and seeded-id
    prompts over the vocabulary; exactly 3 x WHISPER_LAYERS K1 and 2 x
    WHISPER_LAYERS x N_NEW K2 launches a generate, and each job's bytes
    moved whole by a switch. The launches are written into the K1 and K2
    records' whisper rows, one per shape."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.rl import data as data_lib

    cfg = get_config(WHISPER_ARCH)
    if spec_bytes(cfg) != WHISPER_BYTES:
        fail(f"whisper's specs hold {spec_bytes(cfg)} B, not {WHISPER_BYTES}")
    overrides = (("num_layers", WHISPER_LAYERS),
                 ("encoder_layers", WHISPER_LAYERS))
    want = {"flash_attention": 3 * WHISPER_LAYERS,
            "decode_attention": 2 * WHISPER_LAYERS * N_NEW, "ssd": 0}
    rng = np.random.default_rng(0)
    router, launches = serve_phase(
        torch, dev, 25, WHISPER_ARCH, WHISPER_P, want,
        prompts=[rng.integers(data_lib.EOS + 1, cfg.vocab_size,
                              size=(B, WHISPER_P), dtype=np.int32)
                 for _ in range(4)],
        extras=[{"frames": whisper_frames(torch, dev, B, r)}
                for r in range(4)], overrides=overrides)
    # each generate ran WHISPER_LAYERS K1 launches at each of K1's three
    # shapes and WHISPER_LAYERS * N_NEW K2 at each of K2's two (the exact
    # counts were checked every round)
    for name, rows in (("flash_attention", ("whisper_encoder",
                                            "whisper_cross",
                                            "whisper_self_prefill")),
                       ("decode_attention", ("whisper_cross",
                                             "whisper_self"))):
        for row in rows:
            path_launches(records, {name: launches[name] // len(rows)},
                          {name: 1}, row)
    return router


def whisper_parity_phase(torch, dev):
    """Phase 26: card vs CPU for whisper-large-v3 at full width cut to
    WHISPER_PARITY_LAYERS encoder and decoder layers, as phase 5 (B=2,
    prompt 64, 8 teacher-forced decode steps) over frames at the real
    encoder_seq of 1,500; the bound counts the encoder and decoder layers
    together."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    model = build_model(get_config(WHISPER_ARCH).replace(
        num_layers=WHISPER_PARITY_LAYERS,
        encoder_layers=WHISPER_PARITY_LAYERS))
    params = model.init_params(torch.Generator(device=dev).manual_seed(1),
                               dev)
    frames = whisper_frames(torch, torch.device("cpu"), 2, 7)
    parity_phase(torch, model, params, dev, 26, extra={"frames": frames})


def vision_embeddings(torch, dev, b, seed, scale=VISION_SCALE,
                      shared=False):
    """Stub patch embeddings (B, 1601, d_model) bf16 at ``scale`` (the
    reference's ``dummy_batch`` scale by default), drawn from a seeded
    generator on ``dev``; with ``shared``, each row's patches also share
    one unit-scale component, as an image's patches do."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, VISION_T, get_config(VISION_ARCH).d_model)
    x = torch.randn(shape, generator=gen, device=dev)
    if shared:
        x += torch.randn((b, 1, shape[2]), generator=gen, device=dev)
    return (scale * x).to(torch.bfloat16)


def vision_gates(torch, groups, device):
    """Both gates of every cross layer at VISION_GATE, as a partial
    parameter tree."""
    return {"cross_layers": {g: torch.full((groups,), VISION_GATE,
                                           dtype=torch.float32,
                                           device=device)
                             for g in ("gate_attn", "gate_mlp")}}


def vision_serve_phase(torch, dev, records):
    """Phase 27: ``serve_phase`` for one llama-3.2-vision-90b job at full
    width, cut to VISION_LAYERS layers: INIT, then both gates of each cross
    layer written to VISION_GATE through ``StateManager.write`` (zero at
    init, they would hide the cross path) and read back, then three
    generates of seeded-id prompts, each given its own bf16 patch
    embeddings through ``extra_inputs``; exactly VISION_LAYERS K1 and
    VISION_LAYERS * N_NEW K2 launches a generate, and the job's bytes
    those of the cut config's specs. The launches are written into the K1
    and K2 records' vision rows, one per shape."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.rl import data as data_lib

    overrides = (("num_layers", VISION_LAYERS),)
    cfg = get_config(VISION_ARCH).replace(**dict(overrides))
    groups = VISION_LAYERS // VISION_PERIOD
    n_self = groups * (VISION_PERIOD - 1)
    want = {"flash_attention": VISION_LAYERS,
            "decode_attention": VISION_LAYERS * N_NEW, "ssd": 0}

    def write_gates(router, dep):
        router.state_managers[0].write(dep.wpg.job_prefix,
                                       vision_gates(torch, groups, dev))
        got = {g: dep.wpg.params()["cross_layers"][g].tolist()
               for g in ("gate_attn", "gate_mlp")}
        print(f"  gates written after INIT {dep.wpg.job_prefix}: {got}")
        if any(v != VISION_GATE for vals in got.values() for v in vals):
            fail(f"the gates read back {got}, not {VISION_GATE}")

    rng = np.random.default_rng(0)
    router, launches = serve_phase(
        torch, dev, 27, VISION_ARCH, VISION_P, want,
        prompts=[rng.integers(data_lib.EOS + 1, cfg.vocab_size,
                              size=(B, VISION_P), dtype=np.int32)
                 for _ in range(3)],
        extras=[{"vision": vision_embeddings(torch, dev, B, r)}
                for r in range(3)],
        order="AA", overrides=overrides, after_init=write_gates)
    # each generate ran n_self K1 causal and groups non-causal, n_self *
    # N_NEW K2 over the self cache and groups * N_NEW over the cross K/V
    # (the exact counts were checked every round)
    for name, row, part in (("flash_attention", "vision_self_prefill",
                             n_self),
                            ("flash_attention", "vision_cross_prefill",
                             groups),
                            ("decode_attention", "vision_self_decode",
                             n_self),
                            ("decode_attention", "vision_cross_decode",
                             groups)):
        path_launches(records, {name: launches[name] * part //
                                VISION_LAYERS}, {name: 1}, row)
    return router


def vision_parity_phase(torch, dev):
    """Phase 28: card vs CPU for llama-3.2-vision-90b at full width cut to
    one group (VISION_PERIOD layers: 4 self layers and the gated cross
    layer), both gates at VISION_GATE, as phase 5 (B=2, prompt 64) but
    with 4 teacher-forced decode steps, over patch embeddings at the real
    vision_seq of 1,601. First, on the card, the prefill's logits must
    move by more than the parity tolerance when the patch embeddings are
    negated: the cross path reaches the logits. At the seeded init the
    queries are near zero, every key weighs alike and the cross attention
    returns the mean of the values; for independent patch embeddings
    that mean is 1/40 of a value, and even at unit scale negating them
    moved the logits by 0.078 against a tolerance of 0.089 (PERF.md).
    So each row's patches share a unit-scale component beside their own
    unit noise (``vision_embeddings(shared=True)``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    model = build_model(get_config(VISION_ARCH).replace(
        num_layers=VISION_PERIOD))
    params = model.init_params(torch.Generator(device=dev).manual_seed(1),
                               dev)
    for g, t in vision_gates(torch, 1, dev)["cross_layers"].items():
        params["cross_layers"][g].copy_(t)
    vision = vision_embeddings(torch, torch.device("cpu"), 2, 7, scale=1.0,
                               shared=True)
    prompt, _ = parity_prompt(torch, model.cfg, 2, 64, 8)
    with torch.inference_mode():
        logits = [model.forward(params, {"tokens": prompt.to(dev),
                                         "vision": sign * vision.to(dev)})[0]
                  for sign in (1, -1)]
    moved = (logits[0] - logits[1]).abs().max().item()
    tol = 2.0 ** -6 * math.sqrt(VISION_PERIOD / 4) * \
        logits[0].abs().max().item()
    print(f"phase 28: the card's prefill logits move by {moved} when the "
          f"patch embeddings are negated (the parity tolerance {tol})")
    if not moved > tol:
        fail(f"the cross path moves the logits by {moved}, within {tol}")
    del logits
    parity_phase(torch, model, params, dev, 28, n=4,
                 extra={"vision": vision})


# ------------------------------------------ phases 29, 30: cost, examples

def cost_steps(torch, dev):
    """Phase 29's steps: (label, step, card arguments, meta arguments,
    {kernel: launches}). qwen2-0.5b at full width and depth (its prefill
    at B=16 S=128, one decode step at T=192 pos=191, one update_actor at
    phase 8's packed B=16 S=128) and mamba2-2.7b at full width cut to
    COST_SSM_LAYERS layers (its prefill at B=16 S=512, phase 6's K3)."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.models.registry import build_model
    from repro_torch.rl import grpo
    from repro_torch.train import train_state as ts

    gen = torch.Generator(device=dev).manual_seed(29)
    qwen = build_model(get_config(ARCH))
    mamba = build_model(get_config(SSM_ARCH).replace(
        num_layers=COST_SSM_LAYERS))
    state = ts.init(qwen, gen, device=dev)
    t_cap = P + N_NEW
    prefill = ShapeSpec("prefill", "prefill", P, B)
    decode = ShapeSpec("decode", "decode", t_cap, B)
    train = ShapeSpec("train", "train", TRAIN["seq_len"],
                      TRAIN["batch_size"])
    ssm = ShapeSpec("prefill", "prefill", SSM_P, B)
    return [
        (f"qwen2-0.5b prefill B={B} S={P}", grpo.make_prefill(qwen),
         (state.params, qwen.dummy_batch(gen, prefill)),
         (qwen.abstract_params(), qwen.abstract_batch(prefill)),
         {"flash_attention": LAYERS}),
        (f"qwen2-0.5b decode B={B} T={t_cap} pos={t_cap - 1}",
         grpo.make_decode(qwen),
         (state.params, dict(qwen.init_cache(gen, B, t_cap, dev),
                             pos=t_cap - 1), qwen.dummy_batch(gen, decode)),
         (qwen.abstract_params(), qwen.abstract_cache(B, t_cap, t_cap - 1),
          qwen.abstract_batch(decode)),
         {"decode_attention": LAYERS}),
        (f"qwen2-0.5b update_actor B={train.global_batch} "
         f"S={train.seq_len}", grpo.make_update_actor(qwen),
         (state, qwen.dummy_batch(gen, train)),
         (ts.abstract(qwen), qwen.abstract_batch(train)),
         {"flash_attention": 2 * LAYERS}),        # forward and recompute
        (f"mamba2-2.7b ({COST_SSM_LAYERS} layers) prefill B={B} S={SSM_P}",
         grpo.make_prefill(mamba),
         (mamba.init_params(gen, dev), mamba.dummy_batch(gen, ssm)),
         (mamba.abstract_params(), mamba.abstract_batch(ssm)),
         {"ssd": COST_SSM_LAYERS}),
    ]


def cost_phase(torch, dev, card):
    """Phase 29: each step through ``launch/hlo_cost`` once on the card and
    once on ``meta`` tensors. Their FLOPs, bytes, op counts and per-kernel
    launches and work must be equal exactly; each kernel's counted
    launches must equal the change in ``kops.LAUNCHES`` (set to 0 before
    the step) and the path's own count; K1's, K2's and K3's work a launch
    must be PERF.md's bound-column figures. Then the step once more under
    the profiler: its counted FLOPs over the device busy time, as a share
    of the 989 TFLOP/s bf16 peak.

    The temporaries: each step's peak of live bytes tracked on ``meta``
    (``hlo_cost``, the dry run's ``temp_bytes`` plus the outputs it makes)
    must lie within 10 % + 64 MiB (the allocator's block rounding and
    cuBLAS's workspace) of the card's ``max_memory_allocated()`` less the
    bytes allocated before the step, after ``reset_peak_memory_stats()``;
    the same tracker's figure on the card is printed beside them."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import hlo_cost
    from repro_torch.launch.mesh import HW

    keys = ("flops", "traffic_bytes", "ops", "kernels")
    for label, step, args, meta_args, want in cost_steps(torch, dev):
        print(f"phase 29: {label}")
        kops.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        with hlo_cost.Counter() as counter:
            step(*args)
            torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        card_peak = torch.cuda.max_memory_allocated(dev) - before
        on_card = counter.stats()
        launched = dict(kops.LAUNCHES)
        t0 = time.perf_counter()
        on_meta = hlo_cost.analyze(step, *meta_args)
        t_meta = time.perf_counter() - t0
        meta_peak = on_meta["peak_live_bytes"]
        print(f"  temporaries: meta peak above the arguments {meta_peak} B, "
              f"card max_memory_allocated less before {card_peak} B "
              f"(ratio {meta_peak / card_peak}), the card's tracked peak "
              f"{on_card['peak_live_bytes']} B")
        if abs(meta_peak - card_peak) > 0.1 * card_peak + 64 * 2 ** 20:
            fail(f"{label}: meta peak {meta_peak} B against the card's "
                 f"{card_peak} B")
        counted = {k: v["launches"] for k, v in on_card["kernels"].items()}
        print(f"  card ({t_card} s counted): {on_card['flops']} FLOP, "
              f"{on_card['traffic_bytes']} B, {on_card['ops']} ops, "
              f"kernels {on_card['kernels']}; meta ({t_meta} s): "
              f"{on_meta['flops']} FLOP, {on_meta['traffic_bytes']} B, "
              f"{on_meta['ops']} ops; LAUNCHES {launched}")
        if {k: on_card[k] for k in keys} != {k: on_meta[k] for k in keys}:
            fail(f"{label}: the card counts {[on_card[k] for k in keys]}, "
                 f"meta {[on_meta[k] for k in keys]}")
        if counted != launched:
            fail(f"{label}: counted launches {counted}, LAUNCHES {launched}")
        for name, n in want.items():
            work = on_card["kernels"][name]
            if counted[name] != n:
                fail(f"{label}: {counted[name]} {name} launches, want {n}")
            per = (work["flops"] // n, work["bytes"] // n)
            if (work["flops"], work["bytes"]) != \
                    (n * PERF_WORK[name][0], n * PERF_WORK[name][1]):
                fail(f"{label}: {name} work a launch {per}, PERF.md's "
                     f"bound column {PERF_WORK[name]}")
            print(f"  {name}: {n} launches of {per[0]} FLOP and {per[1]} B "
                  f"each (PERF.md's bound column)")
        _, busy = profile_round(torch, lambda: (step(*args),
                                                torch.cuda.synchronize()))
        share = on_card["flops"] / busy / HW["peak_flops_bf16"]
        print(f"  {label}: counted {on_card['flops']} FLOP over "
              f"{busy * 1e3} ms device busy: {share} of "
              f"{HW['peak_flops_bf16'] / 1e12:.0f} TFLOP/s bf16 ({card})")


def examples_phase(torch, tmp, records):
    """Phase 30: the port's examples on the card, at the reference's head
    widths (quickstart 16, multiplex_rlvr 12, padded to 16 in K1 and K2),
    each with the kernels' launch counts set to 0 before it and read
    after: quickstart whole, cluster_sim (host code: it launches nothing),
    multiplex_rlvr's Parts 1-2 through its ``run(...)``, Parts 3, 4 and 6
    (Part 6 must preempt or hold the best-effort lab-1 and then admit
    lab-2) and Part 5 (a virtual clock: no launch), and train_100m
    --steps 2 in a child process. Each prints its seconds; no failure is
    caught. The kernels' ``examples_d16`` rows take quickstart's launches,
    the ``examples_d12`` rows those of multiplex_rlvr's six parts."""
    from repro_torch.examples import cluster_sim, multiplex_rlvr, quickstart
    from repro_torch.kernels import ops as kops

    def example(label, fn, kernels=("flash_attention", "decode_attention")):
        print(f"phase 30: {label}")
        kops.reset_launches()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        print(f"  {label} took {time.monotonic() - t0} s; launches "
              f"{dict(kops.LAUNCHES)}")
        for name in kernels:
            if kops.LAUNCHES[name] == 0:
                fail(f"{label} launched no {name}")
        return dict(kops.LAUNCHES)

    def rows(width, launches):
        for name in ("flash_attention", "decode_attention"):
            records[name][f"examples_d{width}"]["launches"] = launches[name]

    rows(16, example("quickstart", lambda: quickstart.main([])))
    example("cluster_sim", lambda: cluster_sim.main([]), kernels=())

    def parts_1_2():
        for kw in (dict(interleave=False), dict(interleave=True),
                   dict(interleave=True, n_groups=2),
                   dict(interleave=True, n_groups=2, concurrent=True)):
            cluster, billing, wall = multiplex_rlvr.run(**kw)
            steps = {j: billing[j].steps for j in ("alpha", "beta")}
            print(f"  run({kw}): wall {wall} s, steps {steps}, switches "
                  f"{len(cluster.router.switch_log)}")
            if steps != {"alpha": 3, "beta": 3}:
                fail(f"multiplex_rlvr run({kw}) billed {steps}")

    parts = [example("multiplex_rlvr Parts 1-2", parts_1_2)]

    def part3():
        cluster = multiplex_rlvr.part3_serve_mode()
        steps = {j: cluster.billing[j].steps
                 for j in ("alpha", "beta", "gamma")}
        print(f"  Part 3 billed steps {steps}")
        if steps["alpha"] != 3 or steps["beta"] != 3 or not steps["gamma"]:
            fail(f"multiplex_rlvr Part 3 billed {steps}")

    def part4():
        cluster = multiplex_rlvr.part4_auto_placement()
        phases = {j: cluster.director.job_state(j).phase
                  for j in ("alpha", "beta", "delta")}
        if phases["alpha"] != "warm" or phases["beta"] != "warm":
            fail(f"multiplex_rlvr Part 4 phases {phases}")

    def part6():
        cluster = multiplex_rlvr.part6_multi_tenant_service()
        events = [e for e in cluster.director.events
                  if e["event"] in ("slo_preempt", "slo_hold")]
        print(f"  Part 6 trigger 4: {events}")
        if not events or events[0]["job"] != "lab-1" or \
                "lab-2" not in cluster.controllers:
            fail("multiplex_rlvr Part 6 neither preempted nor held lab-1, "
                 "or never admitted lab-2")

    parts += [example("multiplex_rlvr Part 3", part3),
              example("multiplex_rlvr Part 4", part4),
              example("multiplex_rlvr Part 5",
                      multiplex_rlvr.part5_drift_reconciliation, kernels=()),
              example("multiplex_rlvr Part 6", part6)]
    rows(12, {name: sum(p[name] for p in parts) for name in parts[0]})

    argv = ["--steps", "2", "--ckpt-dir", os.path.join(tmp, "train_100m")]
    print(f"phase 30: python -m repro_torch.examples.train_100m "
          f"{' '.join(argv)} (a child process, its default device)")
    code = "\n".join([
        "import json, runpy, sys",
        "from repro_torch.kernels import ops",
        f"sys.argv = ['repro_torch.examples.train_100m'] + {argv!r}",
        "ops.reset_launches()",
        "runpy.run_module('repro_torch.examples.train_100m',",
        "                 run_name='__main__', alter_sys=True)",
        "print('launches ' + json.dumps(ops.LAUNCHES))"])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    for line in proc.stdout.splitlines():
        print(f"  {line}")
    if proc.returncode != 0:
        fail(f"train_100m exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    launches = json.loads(lines[-1].split(" ", 1)[1])
    print(f"  train_100m took {time.monotonic() - t0} s (child process); "
          f"launches {launches}")
    if not any(ln.startswith("[job0] steps=2") for ln in lines) or \
            not launches["flash_attention"] or \
            not launches["decode_attention"]:
        fail(f"train_100m: {lines[-4:]}")


def offset_timing(torch, randn, b, s, q_off, t_cap, h, kh, d, iters=200,
                  timed=True, **opts):
    """K1 with a query offset: ``s`` queries at positions q_off.. over the
    first t = q_off + s rows of (B, T_cap, K, D) caches, read in place
    (views), checked against its plain version and, if ``timed``, timed
    beside its bound (the keys attended: from the window's first on) and
    the library call: SDPA with a boolean mask over the sliced caches, or
    where SDPA takes no softcap ``flex_attention`` compiled."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import bound

    g, t = h // kh, q_off + s
    window = opts.get("window", 0)
    flops, per_call = ops.flash_attention_work(b, s, t, h, kh, d, 2,
                                               window=window, q_off=q_off)
    sets = [(Q_SCALE * randn(b, s, h, d), randn(b, t_cap, kh, d),
             randn(b, t_cap, kh, d))
            for _ in range(n_sets(per_call) if timed else 1)]
    shape = (f"B={b} S={s} q_off={q_off} T={t} of {t_cap} H={h} K={kh} "
             f"D={d}" + "".join(f" {k} {v}" for k, v in opts.items()))

    def kernel(q, kc, vc):
        return ops.flash_attention(q, kc[:, :t], vc[:, :t], q_off=q_off,
                                   **opts)

    def plain(q, kc, vc):
        return ref.ref_attention(q, kc[:, :t].repeat_interleave(g, 2),
                                 vc[:, :t].repeat_interleave(g, 2),
                                 q_off=q_off, **opts)

    err = check_close(torch, shape, kernel(*sets[0]), plain(*sets[0]))
    if not timed:
        return dict(shape=shape, max_abs_err=err)
    if opts.get("softcap") or window:
        flex = flex_call(torch, s, t, q_off, **opts)

        def library(q, kc, vc):
            return flex(q, kc[:, :t], vc[:, :t])

        library.label = flex.label
    else:
        mask = (torch.arange(t, device=sets[0][0].device)[None, :]
                <= q_off + torch.arange(s, device=sets[0][0].device)[:, None])

        def library(q, kc, vc):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kc[:, :t].transpose(1, 2),
                vc[:, :t].transpose(1, 2), attn_mask=mask, enable_gqa=True,
                scale=opts.get("scale")).transpose(1, 2)

        library.label = "sdpa (boolean mask)"
    t_kernel = time_ms(torch, kernel, sets, iters)
    t_plain = time_ms(torch, plain, sets, max(4, iters // 10))
    d_kernel = device_ms(torch, kernel, sets, 20)
    t_lib, d_lib = library_times(torch, library, sets, iters, 20)
    t_bound, by = bound(per_call, flops)
    print(f"  timing {shape}: kernel {t_kernel} ms (device {d_kernel} ms), "
          f"plain {t_plain} ms, {library.label} {t_lib} ms (device "
          f"{d_lib} ms), bound {t_bound} ms ({by}: {per_call} B, {flops} "
          f"FLOP)")
    return dict(shape=shape, max_abs_err=err, ms=t_kernel,
                device_ms=d_kernel, plain_ms=t_plain, bound_ms=t_bound,
                bound_by=by, library_ms=t_lib, library_device_ms=d_lib,
                library=library.label)


def offset_phase(torch, dev, records):
    """Phase 31: multi-token cache writes. For each of OFFSET_CASES and
    each s of OFFSET_S, K1 with a query offset against its plain version,
    timed at the s of OFFSET_TIMED (``offset_timing``); then ``attn_apply`` with those s new
    tokens at cache_pos on the card (K1 over the cache read in place)
    against the same layer on the CPU (the port of the reference's XLA
    branch), through one full-width attention layer of the model with
    seeded weights at B=2, with K1's launches counted from 0: exactly one
    a call, and no other kernel. The outputs and the written caches are
    held at the bf16 tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import common
    from repro_torch.models import layers as tl

    gen = torch.Generator(device=dev).manual_seed(31)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    fa = records["flash_attention"]
    errs = []
    for label, arch, b, cache_pos, opts in OFFSET_CASES:
        cfg = get_config(arch)
        h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        t_cap = cache_pos + max(OFFSET_S) + 64
        window = opts.get("window", 0)
        print(f"phase 31: {arch} (H={h} K={kh} D={d}) cache_pos {cache_pos}"
              f" of {t_cap} {opts}")
        params = common.init_params(gen, tl.attn_param_specs(cfg), dev)
        cpu_params = {k: v.cpu() for k, v in params.items()}
        for s in OFFSET_S:
            row = offset_timing(torch, randn, b, s, cache_pos, t_cap, h, kh,
                                d, iters=100 if b == 1 else 200,
                                timed=s in OFFSET_TIMED, **opts)
            x = Q_SCALE * randn(2, s, cfg.d_model)
            live = (torch.arange(t_cap, device=dev) < cache_pos)[
                None, :, None, None]
            k0 = randn(2, t_cap, kh, d) * live
            v0 = randn(2, t_cap, kh, d) * live
            pos = (cache_pos + torch.arange(s, device=dev))[None].expand(2, s)
            cache = {"k": k0.clone(), "v": v0.clone()}
            kops.reset_launches()
            out, _ = tl.attn_apply(params, cfg, x, positions=pos,
                                   window=window, cache=cache,
                                   cache_pos=cache_pos)
            torch.cuda.synchronize()
            launched = dict(kops.LAUNCHES)
            if launched != {"flash_attention": 1, "decode_attention": 0,
                            "ssd": 0}:
                fail(f"attn_apply at {label} s={s} launched {launched}")
            cpu_cache = {"k": k0.cpu(), "v": v0.cpu()}
            expect, _ = tl.attn_apply(cpu_params, cfg, x.cpu(),
                                      positions=pos.cpu(), window=window,
                                      cache=cpu_cache, cache_pos=cache_pos)
            what = f"attn_apply {arch} B=2 s={s} cache_pos={cache_pos}"
            row["attn_apply_max_abs_err"] = check_close(
                torch, what, out.cpu(), expect)
            for n in ("k", "v"):
                check_close(torch, f"{what} cache {n}", cache[n].cpu(),
                            cpu_cache[n])
            row["launches"] = launched["flash_attention"]
            errs += [row["max_abs_err"], row["attn_apply_max_abs_err"]]
            fa[f"offset_{label}_s{s}"] = row
        del params, cpu_params
    fa["max_abs_err"] = max([fa["max_abs_err"]] + errs)


def tp_phase(torch, dev, records):
    """Phase 32: node groups of several devices on the one card's virtual
    devices. Two qwen2-0.5b GRPO jobs at full width cut to TP_LAYERS, one
    on each group of TP_SLICE devices, through ``PlexCluster.run``: each
    op's launches exactly TP_SLICE times the one-device path's (K1 and K2
    run on every device at its local heads), every op billed, every entry
    ``Sharded`` over its group's slice. Then K1 and K2 at the per-device
    shapes against their plain versions and timed, logits over 2 and 4
    devices against one, a live cross-slice migration and a weight sync
    (bit-exact), and one generate on a 4-device slice (the
    head-dim-parallel decode: K1 on every device, no K2)."""
    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.core.router import Router
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import DevicePlane
    from repro_torch.models import common
    from repro_torch.models import sharding as shd

    cfg = get_config(ARCH).replace(num_layers=TP_LAYERS)
    n_new = TP_TRAIN["max_new_tokens"]
    steps = {}

    @contextlib.contextmanager
    def step(name):
        t0 = time.perf_counter()
        yield
        steps[name] = time.perf_counter() - t0
        print(f"  {name}: {steps[name]} s")

    with step("two jobs' two steps"):
        cluster, ctls, launches = slice_train(
            torch, dev, 32, ARCH, (("num_layers", TP_LAYERS),), "AB",
            train=TP_TRAIN)
    router = cluster.router
    want = {op: slice_launches(cfg, op, n_new, TP_SLICE)
            for op in ("init", "generate", "update_actor")}
    if router.device_plane.domains() != {0: 0, 1: 1}:
        fail(f"phase 32: leases {router.device_plane.domains()}")

    gen = torch.Generator(device=dev).manual_seed(32)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    with step("K1 and K2 at the per-device shapes"):
        h, kh = H // TP_SLICE, KH // TP_SLICE
        fa, de = records["flash_attention"], records["decode_attention"]
        fa["tp_prefill"] = flash_timing(torch, randn, B, P, h, kh, D)
        de["tp_decode"] = decode_timing(torch, randn, B, P + n_new,
                                        P + n_new - 1, 500, h, kh, D)
        gens = 2 * TP_TRAIN["steps"]
        fa["tp_prefill"].update(
            launches=gens * want["generate"]["flash_attention"],
            update_actor_launches=launches["flash_attention"]
            - gens * want["generate"]["flash_attention"])
        de["tp_decode"]["launches"] = launches["decode_attention"]
        for rec, row in ((fa, "tp_prefill"), (de, "tp_decode")):
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     rec[row]["max_abs_err"])

    # job A to group 1's slice, live, and a rollout deployment of it on
    # group 0's slice synced from there
    wa = ctls["A"].dep.wpg
    before = {k: [digest(torch, t) for t in shd.local_tensors(v)]
              for k, v in common.canonical_flat(wa.params()).items()}
    with step("migrate job A across slices"):
        moved = cluster.reassign_job("A", 1)
    mig = router.migrate_log[-1]
    after = {k: [digest(torch, t) for t in shd.local_tensors(v)]
             for k, v in common.canonical_flat(wa.params()).items()}
    print(f"  migration: {moved} B, {mig['seconds']} s, cross_mesh "
          f"{mig['cross_mesh']}, now on slice {wa.mesh_slice.device_ids()}")
    if not mig["cross_mesh"] or after != before or \
            wa.mesh_slice.device_ids() != (2, 3):
        fail("phase 32: the cross-slice migration was not bit-exact")
    roll = router.deploy(api.DeploymentSpec(
        deployment_id="A-roll", job_id="A", model_name=ARCH,
        role="rollout"), group_id=0)
    with step("SYNC_WEIGHTS into the other slice"):
        fut = ctls["A"].dep.sync_weights(roll)
        router.drain()
        fut.result()
    src = {k: digest(torch, shd.gather(v)) for k, v in
           common.canonical_flat(wa.params()).items()}
    dst = {k: digest(torch, shd.gather(v)) for k, v in
           common.canonical_flat(roll.wpg.params()).items()}
    print(f"  sync: {len(dst)} leaves onto slice "
          f"{roll.wpg.mesh_slice.device_ids()}, bit-exact {src == dst}")
    if src != dst or roll.wpg.mesh_slice.device_ids() != (0, 1):
        fail("phase 32: the weight sync was not bit-exact")
    del roll, wa, ctls, cluster, router
    release(torch, dev, "phase 32's cluster")

    with step("logits over 1, 2 and 4 devices"):
        tp_parity(torch, dev)

    with step("a generate on a 4-device slice"):
        r4 = Router(device_plane=DevicePlane(devices=[dev] * TP_DEVICES,
                                             slice_size=TP_DEVICES))
        dep = r4.deploy(api.DeploymentSpec(
            deployment_id="C-roll", job_id="C", model_name=ARCH,
            role="rollout", overrides=(("num_layers", TP_LAYERS),)),
            group_id=0)
        dep.init(seed=3)
        r4.drain()
        prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                               device=dev)
        ops.reset_launches()
        out = dep.generate(prompt, max_new_tokens=n_new)
        r4.drain()
        toks = out.result()["tokens"]
        got = dict(ops.LAUNCHES)
        want4 = {"flash_attention": TP_DEVICES * TP_LAYERS,
                 "decode_attention": 0, "ssd": 0}
        print(f"  model={TP_DEVICES}: tokens {tuple(toks.shape)}, launches "
              f"{got} (the decode is the head-dim-parallel branch)")
        if got != want4 or tuple(toks.shape) != (B, n_new):
            fail(f"phase 32: a 4-device generate launched {got}")
    for d in dict.fromkeys([dev] * TP_DEVICES):
        print(f"  {d} max_memory_allocated {torch.cuda.max_memory_allocated(d)}"
              f" B (the {TP_DEVICES} virtual devices are this card)")
    del dep, r4
    release(torch, dev, "the 4-device router")
    print(f"  phase 32 sub-steps: {steps}")


def tp_parity(torch, dev):
    """Prefill and teacher-forced decode logits of the seeded full-width,
    full-depth model over 2 and over 4 virtual devices of the card,
    against the same parameters on the card alone (phase 5's tolerance):
    K1 and K2 at local heads over 2 devices, the head-dim-parallel decode
    over 4, each run's launches exact."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import sharding as shd
    from repro_torch.models.layers import make_ctx
    from repro_torch.models.registry import build_model
    from repro_torch.rl.rollout import _pad_cache

    cfg = get_config(ARCH)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(1),
                               dev)
    prompt, forced = parity_prompt(torch, cfg, 2, 64, 8)
    prompt, forced = prompt.to(dev), forced.to(dev)
    rel_tol = 2.0 ** -6 * math.sqrt(cfg.num_layers / 4)

    def run(prm, ctx):
        with torch.inference_mode():
            lg, _, cache = model.forward(prm, {"tokens": prompt},
                                         return_cache=True, ctx=ctx)
            out = [lg]
            cache = _pad_cache(cache, forced.shape[1])
            for i in range(forced.shape[1]):
                lg, cache = model.decode_step(
                    prm, cache, {"tokens": forced[:, i:i + 1]}, ctx=ctx)
                out.append(lg)
        return out

    one = run(params, None)
    for n in (TP_SLICE, TP_DEVICES):
        ctx = make_ctx(make_local_mesh(1, n, devices=[dev] * n))
        prm = shd.device_put(params, shd.tree_shardings(
            model.logical_axes(), ctx.mesh, ctx.rules, model.param_specs()))
        ops.reset_launches()
        got = run(prm, ctx)
        launched = dict(ops.LAUNCHES)
        hd_par = cfg.num_kv_heads % n != 0
        want = {"flash_attention": n * cfg.num_layers,
                "decode_attention": 0 if hd_par
                else n * cfg.num_layers * forced.shape[1], "ssd": 0}
        worst = 0.0
        for lg1, lgn in zip(one, got):
            err = (lgn - lg1).abs().max().item()
            tol = rel_tol * lg1.abs().max().item()
            worst = max(worst, err / tol)
            if not (torch.isfinite(lgn).all() and err <= tol):
                fail(f"phase 32: logits over {n} devices: {err} > {tol}")
        print(f"  model={n}: prefill and {forced.shape[1]} decode steps, "
              f"worst |diff| / tolerance {worst} (tolerance {rel_tol} * "
              f"max|logit|), launches {launched}")
        if launched != want:
            fail(f"phase 32: model={n} launched {launched}, want {want}")
        del prm
    del params


# --------------------------- phases 33, 34: MoE and ssm over a slice

def slice_plane(dev, n, groups=1):
    """The card as ``n * groups`` virtual devices, carved into groups of
    ``n``."""
    from repro_torch.launch.mesh import DevicePlane
    return DevicePlane(devices=[dev] * (n * groups), slice_size=n)


def slice_launches(cfg, op, n_new, n):
    """An op's launches on a group of ``n`` devices: ``n`` times the one
    device's (each device runs K1, K2 and K3 at its local heads), but no
    K2 where the KV heads do not split over the slice and head_dim does
    (the head-dim-parallel decode, plain PyTorch as the reference's
    XLA)."""
    out = {k: n * v for k, v in launches_per_op(cfg, op, n_new).items()}
    if cfg.num_kv_heads and cfg.num_kv_heads % n and \
            cfg.resolved_head_dim % n == 0:
        out["decode_attention"] = 0
    return out


def slice_layout(torch, phase, label, wpg, want_bytes=None):
    """Fail unless every entry of the deployment is ``Sharded`` on its
    group's slice (and, with ``want_bytes``, the parameters hold them);
    print the bytes each device's locals hold. Returns those bytes."""
    from repro_torch.models import sharding as shd

    sl = wpg.mesh_slice
    keys = wpg.sm.keys_for(wpg.job_prefix)
    local = [0] * sl.n_devices
    split = 0
    for k in keys:
        ref = wpg.sm.entries[k].ref
        if not isinstance(ref, shd.Sharded) or ref.sharding.mesh != sl.mesh:
            fail(f"phase {phase}: {k} is not laid out on its group's slice")
        split += "model" in str(ref.sharding.spec)
        for i, t in enumerate(ref.locals):
            local[i] += t.numel() * t.element_size()
    total = wpg.sm.job_bytes(wpg.job_prefix)
    print(f"  {label}: slice device ids {sl.device_ids()}, {len(keys)} "
          f"entries ({split} split over the slice), {total} B of state "
          f"(global), each device's locals {local} B")
    if want_bytes is not None and total != want_bytes:
        fail(f"phase {phase}: {label} holds {total} B, not {want_bytes}")
    return local


def slice_serve(torch, dev, phase, arch, layers, n, prompt_len, rounds=1,
                overrides=None, shapes=None, extras=None, after_init=None):
    """One rollout deployment of ``arch`` at full width cut to ``layers``
    (or by ``overrides``), on one group of ``n`` virtual devices of the
    card: INIT (the seeded init laid out on the slice), ``after_init(router,
    dep)`` where given, then ``rounds`` generates (B, prompt ``prompt_len``
    of seeded ids, N_NEW new; ``shapes``: each round's (batch, prompt)
    instead; ``extras(r, b)``: round r's ``extra_inputs``), each with
    exactly ``n`` times the one-device launches (the counts set to 0
    before each) and a peak under 80 GB. Returns the router, the
    deployment, each round's launches and the per-device bytes."""
    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.core.router import Router

    overrides = overrides or (("num_layers", layers),)
    cfg = get_config(arch).replace(**dict(overrides))
    shapes = shapes or [(B, prompt_len)] * rounds
    want = slice_launches(cfg, "generate", N_NEW, n)
    print(f"phase {phase}: serving {arch} at full width, {dict(overrides)}, "
          f"on a group of {n} virtual devices of {dev} ((B, prompt) "
          f"{shapes}, {N_NEW} new; {spec_bytes(cfg)} B of parameters); "
          f"want {want} a generate")
    router = Router(device_plane=slice_plane(dev, n))
    dep = router.deploy(api.DeploymentSpec(
        deployment_id=f"slice-{n}", job_id="S", model_name=arch,
        role="rollout", overrides=overrides), group_id=0)
    gen = torch.Generator(device=dev).manual_seed(phase)
    with router:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        dep.init(seed=1).wait(timeout=900)
        print(f"  INIT: {time.perf_counter() - t0} s; peak card memory "
              f"{torch.cuda.max_memory_allocated(dev)} B")
        if after_init:
            after_init(router, dep)
        local = slice_layout(torch, phase, "rollout", dep.wpg,
                             spec_bytes(cfg))
        rounds_launched = [
            slice_generate(torch, dev, phase, dep, cfg, b, p, want, gen,
                           extras(r, b) if extras else None, f"generate {r}")
            for r, (b, p) in enumerate(shapes)]
        print(f"  exec_log: {list(dep.wpg.exec_log)}")
    return router, dep, rounds_launched, local


def slice_generate(torch, dev, phase, dep, cfg, b, prompt_len, want, gen,
                   extra, label):
    """One generate of the deployment ``dep`` on its group's slice (B=``b``,
    a prompt of ``prompt_len`` seeded ids, N_NEW new, ``extra`` as its
    ``extra_inputs``), the counts set to 0 before it: fail unless it
    launched exactly ``want``, its tokens and logprobs are in range and the
    card's peak is under 80 GB. Returns its launches."""
    from repro_torch.kernels import ops
    from repro_torch.rl import data as data_lib

    prompt = torch.randint(data_lib.EOS + 1, cfg.vocab_size,
                           (b, prompt_len), generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    out = dep.generate(prompt, max_new_tokens=N_NEW, temperature=0.7,
                       extra_inputs=extra).wait(timeout=600)
    wall = time.perf_counter() - t0
    got = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    toks, logps = out["tokens"], out["logprobs"]
    print(f"  {label} (B={b}, prompt {prompt_len}): wall {wall} s, "
          f"{b * N_NEW / wall} tok/s, launches {got}, peak card memory "
          f"{peak} B")
    if got != want:
        fail(f"phase {phase}: a generate over {dep.wpg.mesh_slice.n_devices}"
             f" devices launched {got}, want {want}")
    if tuple(toks.shape) != (b, N_NEW) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()) or \
            not bool(torch.isfinite(logps).all()) or peak >= 80e9:
        fail(f"phase {phase}: {label}: tokens {tuple(toks.shape)}, "
             f"logprobs or peak {peak} B")
    return got


def slice_logits(torch, model, params, ctx, prompt, forced, extra=None):
    """The prefill's logits (``extra``: its inputs beside the tokens), then
    each teacher-forced decode step's, over ``ctx``'s slice (or one
    device)."""
    from repro_torch.rl.rollout import _pad_cache

    with torch.inference_mode():
        lg, _, cache = model.forward(params, {"tokens": prompt,
                                              **(extra or {})},
                                     return_cache=True, ctx=ctx)
        out = [lg]
        cache = _pad_cache(cache, forced.shape[1])
        for i in range(forced.shape[1]):
            lg, cache = model.decode_step(
                params, cache, {"tokens": forced[:, i:i + 1]}, ctx=ctx)
            out.append(lg)
    return out


def slice_parity(torch, dev, phase, arch, layers, b=2, p=64, n_new=8,
                 replace=(), extra=None, after_init=None):
    """Prefill and teacher-forced decode logits of the seeded model at full
    width cut to ``layers`` (and ``replace``'s other fields), over 2 and
    over 4 virtual devices of the card, against the same parameters on the
    card alone, within phase 5's bound (its depth whisper's encoder and
    decoder layers); each run's launches exactly n times the one-device
    run's. ``extra``: the prefill's inputs beside the tokens, on the card;
    ``after_init(params)``: run on the seeded parameters first. For the MoE
    each slice run's expert ids are recorded and the one-device run then
    replays them with its own gates (as phase 20 replays the card's on the
    CPU), so both compute one function; the flips (the one-device run's
    own choice against the slice's) must be near-ties of the router's
    logits and at most MOE_FLIP_SHARE of the choices."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import sharding as shd
    from repro_torch.models.layers import make_ctx
    from repro_torch.models.registry import build_model

    cfg = get_config(arch).replace(num_layers=layers, **dict(replace))
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(1),
                               dev)
    if after_init:
        after_init(params)
    prompt, forced = parity_prompt(torch, cfg, b, p, n_new)
    prompt, forced = prompt.to(dev), forced.to(dev)
    rel_tol = 2.0 ** -6 * math.sqrt((cfg.num_layers + cfg.encoder_layers) / 4)
    print(f"phase {phase}: logits of {arch} at full width cut to {layers} "
          f"layers{f', {dict(replace)}' if replace else ''} over 2 and 4 "
          f"virtual devices against one, B={b} P={p}, {n_new} teacher-forced "
          f"decode steps (tolerance {rel_tol} * max|logit|)")
    one_launch = None
    for n in (2, 4):
        ctx = make_ctx(make_local_mesh(1, n, devices=[dev] * n))
        prm = shd.device_put(params, shd.tree_shardings(
            model.logical_axes(), ctx.mesh, ctx.rules, model.param_specs()))
        replay = RouteReplay(phase, f"model={n} vs one device")
        moe_on = cfg.num_experts > 0
        ops.reset_launches()
        t0 = time.perf_counter()
        with replay.recording(n) if moe_on else contextlib.nullcontext():
            got = slice_logits(torch, model, prm, ctx, prompt, forced,
                               extra)
        t_slice = time.perf_counter() - t0
        launched = dict(ops.LAUNCHES)
        ops.reset_launches()
        t0 = time.perf_counter()
        with replay.replaying() if moe_on else contextlib.nullcontext():
            one = slice_logits(torch, model, params, None, prompt, forced,
                               extra)
        t_one = time.perf_counter() - t0
        one_launch = dict(ops.LAUNCHES)
        want = {k: n * v for k, v in one_launch.items()}
        if slice_launches(cfg, "generate", 1, n)["decode_attention"] == 0:
            want["decode_attention"] = 0
        worst = 0.0
        for lg1, lgn in zip(one, got):
            err = (lgn - lg1).abs().max().item()
            tol = rel_tol * lg1.abs().max().item()
            worst = max(worst, err / tol)
            if not (torch.isfinite(lgn).all() and err <= tol):
                fail(f"phase {phase}: logits over {n} devices: {err} > {tol}")
        print(f"  model={n}: {t_slice} s (one device {t_one} s), worst "
              f"|diff| / tolerance {worst}, launches {launched} (one device "
              f"{one_launch})")
        if launched != want:
            fail(f"phase {phase}: model={n} launched {launched}, want {want}")
        if moe_on:
            replay.check(cfg.experts_per_token)
        del prm
    del params


def slice_update_parity(torch, dev, phase, arch, layers, n=2, overrides=None,
                        extra=None):
    """One update_actor of ``arch`` at full width cut to ``layers`` (or by
    ``overrides``) on a group of ``n`` virtual devices of the card against
    the same on the card alone, from the same parameters and batch (phase
    9's tolerances): loss, pg_loss, kl, aux within 5e-2, grad_norm within
    5 %, each leaf's f32 mu within 5e-2 * max|mu|; the slice's launches
    exactly n times the one device's. ``extra(b)``: the batch's inputs
    beside the tokens. The slice runs first; its metrics and moments are
    kept on the host and the slice is freed before the one-device run, so
    one deployment's train state is on the card at a time. For the MoE the
    one device replays the slice's expert ids (:class:`RouteReplay`, every
    flip a near-tie): a flipped near-tie moves the router's gradient by
    several per cent of its largest."""
    from repro_torch.core import api
    from repro_torch.core.state_manager import StateManager
    from repro_torch.core.worker import WorkerProcessGroup
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import MeshSlice
    from repro_torch.models import common
    from repro_torch.models import sharding as shd
    from repro_torch.train.optimizer import AdamWConfig

    overrides = overrides or (("num_layers", layers),)
    spec = api.DeploymentSpec(deployment_id=f"parity-{arch}", job_id="P",
                              model_name=arch, role="train",
                              overrides=overrides)
    adamw = AdamWConfig(**TRAIN_LR)
    sl = WorkerProcessGroup(spec, StateManager(
        mesh_slice=slice_plane(dev, n).slice_for_group(0)), adamw_cfg=adamw)
    cfg = sl.cfg
    params = sl.model.init_params(
        torch.Generator(device=dev).manual_seed(3), dev)
    # a spread policy, as phase 9's
    params["embed"]["embedding"].mul_(1 / 64)
    sl.execute(api.make_op(spec, api.Op.INIT, params=params))
    params = common.tree_map(lambda t: t.cpu(), params,
                             is_leaf=torch.is_tensor)
    inputs = extra(PARITY_B) if extra else {}
    batch = dict(seeded_train_batch(
        lambda b: sl.execute(api.make_op(spec, api.Op.FORWARD,
                                         dict(b, **inputs))),
        PARITY_B, PARITY_S, PARITY_S // 2, 4), **inputs)
    print(f"phase {phase}: update_actor of {arch} at full width, "
          f"{dict(overrides)}, on {n} virtual devices against one, "
          f"B={PARITY_B} S={PARITY_S}, AdamW {TRAIN_LR}, embedding scaled "
          f"by 1/64")
    out, launched = {}, {}
    replay = RouteReplay(phase, f"update_actor, {n} devices vs one")
    moe_on = cfg.num_experts > 0

    def run(w, where, wrap):
        ops.reset_launches()
        with wrap() if moe_on else contextlib.nullcontext():
            out[where] = w.execute(api.make_op(spec, api.Op.UPDATE_ACTOR,
                                               batch))
        launched[where] = dict(ops.LAUNCHES)
        print(f"  {where}: {w.exec_log[-1][1]} s, launches "
              f"{launched[where]}; {out[where]}; peak card memory "
              f"{torch.cuda.max_memory_allocated(dev)} B")

    run(sl, f"{n} devices", functools.partial(replay.recording, n))
    # the slice's moments on the host, the slice freed, then the one
    # device from the same parameters
    mun = {k: shd.gather(v, "cpu") for k, v in
           common.canonical_flat(sl.opt_state().mu).items()}
    del sl
    release(torch, dev, f"the {n}-device parity WPG")
    one = WorkerProcessGroup(spec, StateManager(mesh_slice=MeshSlice(0, dev)),
                             adamw_cfg=adamw)
    one.execute(api.make_op(spec, api.Op.INIT, params=params))
    del params
    run(one, "one device", replay.replaying)
    if moe_on:
        # the logits phases hold the share of flips. Here a flip of the
        # forward and of its recomputation need only be a near-tie, and
        # the router logits are held within phase 5's bound at this depth
        replay.check(cfg.experts_per_token, share=None,
                     logit_tol=2.0 ** -6 * math.sqrt(cfg.num_layers / 4))
    want = slice_launches(cfg, "update_actor", 0, n)
    if launched[f"{n} devices"] != want:
        fail(f"phase {phase}: update_actor over {n} devices launched "
             f"{launched[f'{n} devices']}, want {want}")
    got, ref = out[f"{n} devices"], out["one device"]
    worst = 0.0
    for k in ("loss", "pg_loss", "kl", "aux", "grad_norm"):
        tol = 5e-2 * (ref[k] if k == "grad_norm" else max(1.0, abs(ref[k])))
        worst = max(worst, abs(got[k] - ref[k]) / tol)
        if not abs(got[k] - ref[k]) <= tol:
            fail(f"phase {phase}: {k} over {n} devices {got[k]}, one "
                 f"device {ref[k]}")
    if not ref["grad_norm"] > 0:
        fail(f"phase {phase}: zero gradient")
    mu1 = common.canonical_flat(one.opt_state().mu)
    for k, want_mu in mu1.items():
        err = (mun[k].to(dev) - want_mu).abs().max().item()
        tol = 5e-2 * want_mu.abs().max().item()
        worst = max(worst, err / tol if tol else 0.0)
        if not err <= tol:
            fail(f"phase {phase}: mu {k} over {n} devices: {err} > {tol}")
    print(f"  metrics and f32 mu of {len(mu1)} leaves within phase 9's "
          f"tolerances (worst |diff| / tolerance {worst})")
    del one, mun


def slice_train(torch, dev, phase, arch, overrides, jobs, n=TP_SLICE,
                train=TRAIN):
    """GRPO jobs (``jobs``: ids, one group each) of ``arch`` at full width
    (cut by ``overrides``), each on its own group of ``n`` virtual devices
    of the card, ``train``'s steps each through ``PlexCluster.run``: each
    op's launches exactly n times the one-device path's (K1, K2 and K3 on
    every device at its local heads), every op billed, every entry
    ``Sharded`` on its group's slice. Returns the cluster, the
    controllers and the launches over the steps."""
    from repro_torch.configs import get_config
    from repro_torch.core.cluster import PlexCluster
    from repro_torch.core.controller import JobConfig
    from repro_torch.kernels import ops

    cfg = get_config(arch).replace(**dict(overrides))
    n_new = train["max_new_tokens"]
    print(f"phase {phase}: GRPO training {arch} at full width and "
          f"{cfg.num_layers} layers, jobs {', '.join(jobs)}, each on a "
          f"group of {n} virtual devices of {dev} ({train})")
    cluster = PlexCluster(n_groups=len(jobs),
                          device_plane=slice_plane(dev, n, len(jobs)))
    ctls = {job: cluster.add_job(JobConfig(
        job_id=job, model_name=arch, seed=g + 1, overrides=overrides,
        **train), group_id=g) for g, job in enumerate(jobs)}
    log = []
    for job, c in ctls.items():
        counted(c.dep.wpg, job, log)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    billing = cluster.run(interleave=True)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    want = {op: slice_launches(cfg, op, n_new, n)
            for op in ("init", "generate", "update_actor")}
    for job, op, sec, grew in log:
        print(f"  job {job} {op}: {sec} s, launches {grew}")
        if grew != want[op]:
            fail(f"phase {phase}: job {job} {op} launched {grew}, want "
                 f"{want[op]}")
    print(f"  {len(log)} ops in {wall} s; launches {launches}; card peak "
          f"{torch.cuda.max_memory_allocated(dev)} B")
    for job, c in ctls.items():
        wpg = c.dep.wpg
        slice_layout(torch, phase, f"job {job} (group "
                     f"{cluster.router.group_of[c.dep.deployment_id]})", wpg)
        rec = billing[job]
        print(f"  bill {job}: busy {rec.busy_seconds} s, switch "
              f"{rec.switch_seconds} s, steps {rec.steps}")
        check_bill(cluster, rec, [wpg], 1 + 2 * train["steps"],
                   train["steps"])
        for i, m in enumerate(c.metrics_log):
            print(f"  job {job} step {i}: loss {m['loss']}, aux {m['aux']}, "
                  f"grad_norm {m['grad_norm']}, lr {m['lr']}")
            if not all(math.isfinite(v) for v in m.values()):
                fail(f"phase {phase}: job {job} step {i}: {m}")
    return cluster, ctls, launches


def slice_kernel_rows(torch, dev, records, rows):
    """K1, K2 and K3 at per-device shapes against their plain versions,
    timed beside their bounds and library calls: ``rows`` holds (kernel,
    row name, timing function, its arguments, launches on the path[, its
    keyword arguments])."""
    gen = torch.Generator(device=dev).manual_seed(33)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    for name, row, fn, args, launches, *kw in rows:
        if name == "ssd":
            rec = ssd_timing(torch, gen, dev, *args)
        else:
            rec = fn(torch, randn, *args, **(kw[0] if kw else {}))
        rec["launches"] = launches
        records[name][row] = rec
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"],
                                           rec["max_abs_err"])


def ep_phase(torch, dev, records):
    """Phase 33: the MoE family over a slice (expert parallelism), the card
    seen as virtual devices. Qwen3-30B-A3B served as one job on a 2-device
    group at full width cut to EP_LAYERS, then one generate over 4
    devices; two granite GRPO jobs on two 2-device groups at full width cut
    to GRANITE_LAYERS, billed, and one migrated live across slices; logits
    over 2 and 4 devices against one (routing replayed) and update_actor
    on a slice against one device; K1 and K2 at the per-device shapes."""
    from repro_torch.configs import get_config
    from repro_torch.models import common
    from repro_torch.models import sharding as shd

    steps = {}

    @contextlib.contextmanager
    def step(name):
        t0 = time.perf_counter()
        yield
        steps[name] = time.perf_counter() - t0
        print(f"  {name}: {steps[name]} s")

    gens = {}
    for n in (TP_SLICE, TP_DEVICES):
        with step(f"Qwen3-30B-A3B over {n} devices"):
            router, dep, got, local = slice_serve(
                torch, dev, 33, MOE_ARCH,
                EP_LAYERS if n == TP_SLICE else EP4_LAYERS, n, MOE_P,
                rounds=EP_ROUNDS if n == TP_SLICE else 1)
            gens[n] = got
            del router, dep
            release(torch, dev, f"the {n}-device Qwen3 router")
    with step("logits over 2 and 4 devices"):
        slice_parity(torch, dev, 33, MOE_ARCH, MOE_PARITY_LAYERS,
                     b=MOE_PARITY_B)
        release(torch, dev, "the Qwen3 parity parameters")
    with step("granite jobs on two slices"):
        cluster, ctls, launches = slice_train(
            torch, dev, 33, GRANITE_ARCH, (("num_layers", GRANITE_LAYERS),),
            "AB")
    wa = ctls["A"].dep.wpg
    before = {k: [digest(torch, t) for t in shd.local_tensors(v)]
              for k, v in common.canonical_flat(wa.params()).items()}
    with step("migrate granite job A across slices"):
        moved = cluster.reassign_job("A", 1)
    mig = cluster.router.migrate_log[-1]
    after = {k: [digest(torch, t) for t in shd.local_tensors(v)]
             for k, v in common.canonical_flat(wa.params()).items()}
    print(f"  migration: {moved} B, {mig['seconds']} s, cross_mesh "
          f"{mig['cross_mesh']}, now on slice {wa.mesh_slice.device_ids()}")
    if not mig["cross_mesh"] or after != before or \
            wa.mesh_slice.device_ids() != (2, 3):
        fail("phase 33: the cross-slice migration was not bit-exact")
    del cluster, ctls, wa
    release(torch, dev, "the granite cluster")
    with step("granite update_actor on a slice against one device"):
        slice_update_parity(torch, dev, 33, GRANITE_ARCH, PARITY_LAYERS)
        release(torch, dev, "the granite parity WPGs")
    with step("K1 and K2 at the per-device shapes"):
        qcfg = get_config(MOE_ARCH).replace(num_layers=EP_LAYERS)
        gcfg = get_config(GRANITE_ARCH).replace(num_layers=GRANITE_LAYERS)
        q2 = gens[TP_SLICE][0]
        # the granite jobs' 4 generates and 4 update_actors
        g_gen = 4 * TP_SLICE * launches_per_op(gcfg, "generate",
                                               N_NEW)["flash_attention"]
        g_upd = launches["flash_attention"] - g_gen
        h, kh = MOE_H // TP_SLICE, MOE_KH // TP_SLICE
        gh, gkh = GRANITE_H // TP_SLICE, GRANITE_KH // TP_SLICE
        slice_kernel_rows(torch, dev, records, (
            ("flash_attention", "ep_qwen3_prefill", flash_timing,
             (B, MOE_P, h, kh, MOE_D), q2["flash_attention"]),
            ("decode_attention", "ep_qwen3_decode", decode_timing,
             (B, MOE_P + N_NEW, MOE_P + N_NEW - 1, 500, h, kh, MOE_D),
             q2["decode_attention"]),
            ("flash_attention", "ep_granite_training", flash_timing,
             (B, TRAIN["seq_len"], gh, gkh, GRANITE_D), g_upd),
            ("decode_attention", "ep_granite_decode", decode_timing,
             (B, TRAIN["seq_len"], TRAIN["seq_len"] - 1, 500, gh, gkh,
              GRANITE_D), launches["decode_attention"]),
        ))
        print(f"  Qwen3 launches a generate over {TP_DEVICES} devices "
              f"{gens[TP_DEVICES][0]}; granite's over the steps {launches} "
              f"({qcfg.num_layers} and {gcfg.num_layers} layers)")
    print(f"  phase 33 sub-steps: {steps}")


def ssm_tp_phase(torch, dev, records):
    """Phase 34: mamba2 and zamba2 over a slice (SSD heads split), the card
    seen as virtual devices. mamba2-2.7b served on a 2-device group at
    full width cut to SSM_TP_LAYERS, then one generate over 4 devices; one
    mamba2 GRPO job on a 2-device group (phase 14's shapes); logits over 2
    and 4 devices against one; update_actor on a slice against one
    device; zamba2-7b served on a 2-device group at full width cut to
    HYB_TP_LAYERS blocks; K3 at 40 and 56 heads a device, K1 and K2 at
    zamba2's local heads."""
    from repro_torch.configs import get_config

    steps = {}

    @contextlib.contextmanager
    def step(name):
        t0 = time.perf_counter()
        yield
        steps[name] = time.perf_counter() - t0
        print(f"  {name}: {steps[name]} s")

    gens = {}
    for n in (TP_SLICE, TP_DEVICES):
        with step(f"mamba2 over {n} devices"):
            router, dep, got, _ = slice_serve(
                torch, dev, 34, SSM_ARCH,
                SSM_TP_LAYERS if n == TP_SLICE else SSM_TP4_LAYERS, n, SSM_P)
            gens[n] = got[0]
            del router, dep
            release(torch, dev, f"the {n}-device mamba2 router")
    with step("mamba2 GRPO job on a slice"):
        cluster, _, train_launches = slice_train(
            torch, dev, 34, SSM_ARCH, (("num_layers", SSM_TRAIN_LAYERS),),
            "M")
        del cluster
        release(torch, dev, "the mamba2 training cluster")
    with step("mamba2 logits over 2 and 4 devices"):
        slice_parity(torch, dev, 34, SSM_ARCH, SSM_TP_PARITY_LAYERS)
        release(torch, dev, "the mamba2 parity parameters")
    with step("mamba2 update_actor on a slice against one device"):
        slice_update_parity(torch, dev, 34, SSM_ARCH, PARITY_LAYERS)
        release(torch, dev, "the mamba2 parity WPGs")
    with step("zamba2 over 2 devices"):
        router, dep, got, _ = slice_serve(torch, dev, 34, HYB_ARCH,
                                          HYB_TP_LAYERS, TP_SLICE, HYB_P)
        z2 = got[0]
        del router, dep
        release(torch, dev, "the zamba2 router")
    with step("K3, K1 and K2 at the per-device shapes"):
        h = SSM_H // TP_SLICE
        zh, zsh = HYB_H // TP_SLICE, HYB_SSM_H // TP_SLICE
        slice_kernel_rows(torch, dev, records, (
            ("ssd", "tp_prefill", None, (h, SSM_N, (("prefill", SSM_P),)),
             gens[TP_SLICE]["ssd"]),
            ("ssd", "tp_zamba2", None, (zsh, HYB_SSM_N, (("prefill", HYB_P),)),
             z2["ssd"]),
            ("flash_attention", "tp_zamba2_prefill", flash_timing,
             (B, HYB_P, zh, zh, HYB_D), z2["flash_attention"]),
            ("decode_attention", "tp_zamba2_decode", decode_timing,
             (B, HYB_P + N_NEW, HYB_P + N_NEW - 1, 500, zh, zh, HYB_D),
             z2["decode_attention"]),
        ))
        print(f"  mamba2 launches a generate over {TP_DEVICES} devices "
              f"{gens[TP_DEVICES]}; a training job's over its steps "
              f"{train_launches}")
    print(f"  phase 34 sub-steps: {steps}")


def whisper_slices(torch, dev, phase):
    """Two whisper-large-v3 rollout jobs at full width cut to
    WHISPER_TP_LAYERS encoder and decoder layers, each on its own group of
    TP_SLICE virtual devices: INIT, a generate each (frames through
    ``extra_inputs``), then job A migrated live to group 1's slice
    (``cross_mesh``, every leaf bit-exact, its device ids) and one more
    generate of A there; every generate's launches exactly TP_SLICE times
    the one-device path's. Returns the launches of the three generates."""
    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.core.router import Router
    from repro_torch.models import common
    from repro_torch.models import sharding as shd

    overrides = (("num_layers", WHISPER_TP_LAYERS),
                 ("encoder_layers", WHISPER_TP_LAYERS))
    cfg = get_config(WHISPER_ARCH).replace(**dict(overrides))
    want = slice_launches(cfg, "generate", N_NEW, TP_SLICE)
    print(f"phase {phase}: two {WHISPER_ARCH} jobs at full width, "
          f"{dict(overrides)}, on two groups of {TP_SLICE} virtual devices "
          f"(B={B}, prompt {WHISPER_P}, frames {(B, WHISPER_T)}, {N_NEW} "
          f"new); want {want} a generate")
    router = Router(device_plane=slice_plane(dev, TP_SLICE, 2))
    deps = {job: router.deploy(api.DeploymentSpec(
        deployment_id=f"whisper-{job}", job_id=job, model_name=WHISPER_ARCH,
        role="rollout", overrides=overrides), group_id=g)
        for g, job in enumerate("AB")}
    gen = torch.Generator(device=dev).manual_seed(phase)
    launched = []
    with router:
        torch.cuda.reset_peak_memory_stats(dev)
        for seed, (job, dep) in enumerate(deps.items(), start=1):
            dep.init(seed=seed).wait(timeout=900)
            slice_layout(torch, phase, f"job {job}", dep.wpg,
                         spec_bytes(cfg))
        for r, job in enumerate("AB"):
            launched.append(slice_generate(
                torch, dev, phase, deps[job], cfg, B, WHISPER_P, want, gen,
                {"frames": whisper_frames(torch, dev, B, r)},
                f"job {job} generate"))
        wa = deps["A"].wpg
        before = {k: [digest(torch, t) for t in shd.local_tensors(v)]
                  for k, v in common.canonical_flat(wa.params()).items()}
        moved = router.reassign_job("A", 1)
        mig = router.migrate_log[-1]
        after = {k: [digest(torch, t) for t in shd.local_tensors(v)]
                 for k, v in common.canonical_flat(wa.params()).items()}
        print(f"  migration: {moved} B, {mig['seconds']} s, cross_mesh "
              f"{mig['cross_mesh']}, now on slice "
              f"{wa.mesh_slice.device_ids()}")
        if not mig["cross_mesh"] or after != before or \
                wa.mesh_slice.device_ids() != (2, 3):
            fail(f"phase {phase}: whisper's cross-slice migration was not "
                 f"bit-exact")
        launched.append(slice_generate(
            torch, dev, phase, deps["A"], cfg, B, WHISPER_P, want, gen,
            {"frames": whisper_frames(torch, dev, B, 2)},
            "job A generate on its new slice"))
        print(f"  card peak {torch.cuda.max_memory_allocated(dev)} B")
    return launched


def write_vision_gates(torch, dev, groups):
    """An ``after_init``: both gates of each cross layer written to
    VISION_GATE through ``StateManager.write`` into their replicated
    leaves on the slice, then every device's copy read back."""
    from repro_torch.models import sharding as shd

    def write(router, dep):
        router.state_managers[0].write(dep.wpg.job_prefix,
                                       vision_gates(torch, groups, dev))
        for g in ("gate_attn", "gate_mlp"):
            leaf = dep.wpg.params()["cross_layers"][g]
            got = [t.tolist() for t in shd.local_tensors(leaf)]
            print(f"  {g} on each device after the write: {got}")
            if any(v != VISION_GATE for vals in got for v in vals):
                fail(f"the gates read back {got}, not {VISION_GATE}")

    return write


def xattn_tp_phase(torch, dev, records):
    """Phase 35: gemma2, whisper and the vlm family over a slice, the card
    seen as virtual devices. gemma2-27b served on a 2-device group at full
    width cut to GEMMA_TP_LAYERS (B=16 prompt GEMMA_P, then B=1 prompt
    GEMMA_LONG_P: the window cuts) and on a 4-device group; two whisper
    jobs on two 2-device groups, one migrated live (``whisper_slices``),
    and one generate on a 4-device group; llama-3.2-vision-90b on a
    4-device group at VISION_LAYERS, its gates written after INIT; logits
    over 2 and 4 devices against one for each family; update_actor on a
    slice against one device for gemma2 and whisper; K1 and K2 at the new
    per-device shapes."""
    steps = {}

    @contextlib.contextmanager
    def step(name):
        t0 = time.perf_counter()
        yield
        steps[name] = time.perf_counter() - t0
        print(f"  {name}: {steps[name]} s")

    def frames(r, b):
        return {"frames": whisper_frames(torch, dev, b, r)}

    def patches(r, b):
        return {"vision": vision_embeddings(torch, dev, b, r)}

    with step("gemma2 over 2 devices"):
        router, dep, g2, _ = slice_serve(
            torch, dev, 35, GEMMA_ARCH, GEMMA_TP_LAYERS, TP_SLICE, GEMMA_P,
            shapes=[(B, GEMMA_P), (1, GEMMA_LONG_P)])
        del router, dep
        release(torch, dev, "the 2-device gemma2 router")
    with step("gemma2 over 4 devices"):
        router, dep, _, _ = slice_serve(torch, dev, 35, GEMMA_ARCH,
                                        GEMMA_TP4_LAYERS, TP_DEVICES, GEMMA_P)
        del router, dep
        release(torch, dev, "the 4-device gemma2 router")
    with step("gemma2 logits over 2 and 4 devices"):
        # phase 24's reason: the final softcap squeezes the logits whose
        # bf16 steps the bound measures; it is f32 code both sides share
        slice_parity(torch, dev, 35, GEMMA_ARCH, GEMMA_PARITY_LAYERS,
                     replace=(("final_logit_softcap", None),))
        release(torch, dev, "the gemma2 parity parameters")
    with step("gemma2 update_actor on a slice against one device"):
        slice_update_parity(torch, dev, 35, GEMMA_ARCH, XATTN_TRAIN_LAYERS)
        release(torch, dev, "the gemma2 parity WPGs")
    with step("whisper jobs on two slices"):
        w2 = whisper_slices(torch, dev, 35)
        release(torch, dev, "the whisper slices' router")
    with step("whisper over 4 devices"):
        router, dep, _, _ = slice_serve(
            torch, dev, 35, WHISPER_ARCH, None, TP_DEVICES, WHISPER_P,
            overrides=(("num_layers", WHISPER_TP4_LAYERS),
                       ("encoder_layers", WHISPER_TP4_LAYERS)),
            extras=frames)
        del router, dep
        release(torch, dev, "the 4-device whisper router")
    with step("whisper logits over 2 and 4 devices"):
        slice_parity(torch, dev, 35, WHISPER_ARCH, WHISPER_PARITY_LAYERS,
                     replace=(("encoder_layers", WHISPER_PARITY_LAYERS),),
                     extra=frames(7, 2))
        release(torch, dev, "the whisper parity parameters")
    with step("whisper update_actor on a slice against one device"):
        slice_update_parity(
            torch, dev, 35, WHISPER_ARCH, None,
            overrides=(("num_layers", XATTN_TRAIN_LAYERS),
                       ("encoder_layers", XATTN_TRAIN_LAYERS)),
            extra=lambda b: frames(9, b))
        release(torch, dev, "the whisper parity WPGs")
    groups = VISION_LAYERS // VISION_PERIOD
    with step("vision over 4 devices"):
        router, dep, v4, local = slice_serve(
            torch, dev, 35, VISION_ARCH, VISION_LAYERS, TP_DEVICES, VISION_P,
            extras=patches,
            after_init=write_vision_gates(torch, dev, groups))
        del router, dep
        release(torch, dev, "the 4-device vision router")
    with step("vision logits over 2 and 4 devices"):
        # phase 28's patch embeddings: unit scale, a component each row's
        # patches share, so the cross path reaches the logits
        gates = vision_gates(torch, 1, dev)["cross_layers"]
        slice_parity(torch, dev, 35, VISION_ARCH, VISION_PERIOD,
                     extra={"vision": vision_embeddings(
                         torch, dev, 2, 7, scale=1.0, shared=True)},
                     after_init=lambda p: [p["cross_layers"][g].copy_(t)
                                           for g, t in gates.items()])
        release(torch, dev, "the vision parity parameters")
    with step("K1 and K2 at the per-device shapes"):
        gh, gkh = GEMMA_H // TP_SLICE, GEMMA_KH // TP_SLICE
        wh = WHISPER_H // TP_SLICE
        vh, vkh = VISION_H // TP_DEVICES, VISION_KH // TP_DEVICES
        gemma = dict(window=GEMMA_WINDOW, softcap=GEMMA_CAP,
                     scale=GEMMA_SCALE)
        # the launches of each shape on the paths above: gemma2's B=16
        # round (every layer K1, every layer and step K2 over 2 devices);
        # whisper's three generates over 2 devices (a third each of K1's
        # for the encoder and the cross prefill, half of K2's the cross
        # decode); vision's over 4 (a cross layer closes each group)
        vfrac = 1 / VISION_PERIOD
        slice_kernel_rows(torch, dev, records, (
            ("flash_attention", "tp_gemma2_prefill", flash_timing,
             (B, GEMMA_P, gh, gkh, GEMMA_D), g2[0]["flash_attention"],
             gemma),
            ("decode_attention", "tp_gemma2_decode", decode_timing,
             (B, GEMMA_P + N_NEW, GEMMA_P + N_NEW - 1, 500, gh, gkh,
              GEMMA_D), g2[0]["decode_attention"], gemma),
            ("flash_attention", "tp_whisper_encoder", flash_timing,
             (B, WHISPER_T, wh, wh, WHISPER_D),
             sum(x["flash_attention"] for x in w2) // 3,
             dict(causal=False)),
            ("flash_attention", "tp_whisper_cross_prefill", flash_timing,
             (B, WHISPER_P, wh, wh, WHISPER_D),
             sum(x["flash_attention"] for x in w2) // 3,
             dict(t=WHISPER_T, causal=False)),
            ("decode_attention", "tp_whisper_cross_decode", decode_timing,
             (B, WHISPER_T, WHISPER_T - 1, 500, wh, wh, WHISPER_D),
             sum(x["decode_attention"] for x in w2) // 2, {}),
            ("flash_attention", "tp_vision_cross_prefill", flash_timing,
             (B, VISION_P, vh, vkh, VISION_D),
             int(sum(x["flash_attention"] for x in v4) * vfrac),
             dict(t=VISION_T, causal=False)),
            ("decode_attention", "tp_vision_cross_decode", decode_timing,
             (B, VISION_T, VISION_T - 1, 500, vh, vkh, VISION_D),
             int(sum(x["decode_attention"] for x in v4) * vfrac), {}),
        ))
        print(f"  vision's state a device over {TP_DEVICES}: {local} B")
    print(f"  phase 35 sub-steps: {steps}")


# ----------------------- phase 36: process-mode groups of several devices

def child_layouts(gp, prefix, digests=False):
    """Where each of a job's entries lies in its child (tier, shape, spec,
    device ids, local devices, replicas alike) and, with ``digests``, a
    digest of each one's gathered bits computed there (its seconds
    printed)."""
    out = gp.call("probe", {"layouts": prefix, "digests": digests})[0]
    if digests:
        print(f"  digests of {len(out['layouts'])} entries of {prefix} in "
              f"group {gp.group_id}'s child: {out['layouts_seconds']} s")
    return out["layouts"]


def host_step_close(torch, got, want):
    """tests/test_torch_ppo.py's tolerances for the host step: rtol 2^-7
    for a bf16 leaf, rtol 1e-5 and atol 1e-7 for f32. Returns the worst
    |diff| over its bound."""
    rtol, atol = (2.0 ** -7, 0.0) if want.dtype == torch.bfloat16 \
        else (1e-5, 1e-7)
    g, w = got.float(), want.float()
    bound = atol + rtol * w.abs()
    diff = (g - w).abs()
    if not bool(torch.isfinite(g).all()) or bool((diff > bound).any()):
        return math.inf
    return float((diff / bound.clamp_min(1e-30)).max())


def proc_tp_phase(torch, dev, records):
    """Phase 36: process-mode node groups of several devices. The card as
    TP_DEVICES virtual devices carved into two slices of TP_SLICE, each
    group in its own spawned child, which sees the slice's devices: two
    qwen2-0.5b GRPO jobs at full width cut to PROC_TP_LAYERS, one step each
    (K1 and K2 at each device's local heads, counted in the children, and
    checked and timed here at those shapes), a greedy generate in a child against thread mode on the same slice, job
    A moved live into the other child (resharded), a cross-process
    SYNC_WEIGHTS into target shardings, a PPO job's step (its gradients
    across the pipe) and OPTIM_STEP(host=True) over the slice in the child
    and in thread mode against one device's host step."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.core.cluster import PlexCluster
    from repro_torch.core.controller import JobConfig
    from repro_torch.core.router import Router
    from repro_torch.core.state_manager import StateManager, Tier
    from repro_torch.core.worker import WorkerProcessGroup
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import MeshSlice, devices_for_slice
    from repro_torch.models import common
    from repro_torch.models import sharding as shd
    from repro_torch.models.registry import build_model
    from repro_torch.rl import data as data_lib
    from repro_torch.train import train_state as tstate
    from repro_torch.train.optimizer import AdamWConfig

    n, n_new = TP_SLICE, TRAIN["max_new_tokens"]
    cut = PROC_TP_OVERRIDES
    cfg = get_config(ARCH).replace(**dict(cut))
    train = dict(TRAIN, steps=1)
    want = {op: slice_launches(cfg, op, n_new, n) for op in
            ("init", "generate", "forward", "forward_backward",
             "update_actor", "optim_step", "sync_weights")}
    gen = torch.Generator().manual_seed(36)
    steps = {}

    @contextlib.contextmanager
    def step(name):
        t0 = time.perf_counter()
        yield
        steps[name] = time.perf_counter() - t0
        print(f"  {name}: {steps[name]} s")

    def run(fut):
        router.drain()
        return fut.result()

    def prompts(b, p):
        return torch.randint(data_lib.EOS + 1, cfg.vocab_size, (b, p),
                             generator=gen)

    def counted_op(gp, fut_fn, label, want_launches):
        """One op through the router, the child's counts set to 0 before
        and read after."""
        gp.call("probe", {"reset": True})
        out = run(fut_fn())
        got = gp.call("probe")[0]["launches"]
        print(f"  {label}: launches {got} in group {gp.group_id}'s child")
        if got != want_launches:
            fail(f"phase 36: {label} launched {got}, want {want_launches}")
        return out, got

    used0 = mem_used(torch, dev)
    print(f"phase 36: process-mode groups of {n} virtual devices of {dev}, "
          f"each group in its own child: {ARCH} at full width, {dict(cut)}, "
          f"jobs A and B ({train}); card {card_line()}; card memory in use "
          f"{used0} B")
    with step("spawn the two children"):
        cluster = PlexCluster(n_groups=2, devices_per_group=n,
                              process_plane=True,
                              device_plane=slice_plane(dev, n, 2))
        router = cluster.router
        gps = router.group_procs
        # both children load torch and build their slice at once (a
        # deployment's creation would load them one child after the other)
        with concurrent.futures.ThreadPoolExecutor(len(gps)) as pool:
            list(pool.map(lambda gp: gp.call("probe", {"layouts": "-"}),
                          gps.values()))
    slices = {g: router.state_managers[g].mesh_slice for g in gps}
    # each child's view of its slice: cuda:0 n times on the one card
    views = {g: devices_for_slice(sl) for g, sl in slices.items()}
    print(f"  children {({g: gp.pid() for g, gp in gps.items()})} (parent "
          f"{os.getpid()}): devices "
          f"{({g: gp.devices for g, gp in gps.items()})}, ids "
          f"{({g: gp.device_ids for g, gp in gps.items()})}, env "
          f"{({g: gp.env for g, gp in gps.items()})}")
    for g, gp in gps.items():
        if gp.devices != views[g] or \
                tuple(gp.device_ids) != slices[g].device_ids():
            fail(f"phase 36: group {g}'s child sees {gp.devices} "
                 f"{gp.device_ids}")
    if len({gp.pid() for gp in gps.values()} | {os.getpid()}) != 3:
        fail("phase 36: the groups do not run in two children of their own")

    # two GRPO jobs, one a group, concurrently, counted in the children
    with step("two jobs' INIT and step"):
        ctls = {job: cluster.add_job(JobConfig(
            job_id=job, model_name=ARCH, seed=g + 1, overrides=cut, **train),
            group_id=g) for g, job in enumerate("AB")}
        log = []
        for job, c in ctls.items():
            counted_in_child(c.dep.wpg, job, log)
        for gp in gps.values():
            gp.call("probe", {"reset": True})
        ops.reset_launches()
        billing = cluster.run(interleave=True, concurrent=True)
    home = {"A": 0, "B": 1}
    per_kernel = {"generate": {}, "update_actor": {}}
    for job, op, sec, grew, pid in log:
        print(f"  job {job} {op}: {sec} s in pid {pid}, launches {grew}")
        if grew != want[op]:
            fail(f"phase 36: job {job} {op} launched {grew}, want {want[op]}")
        if pid != gps[home[job]].pid():
            fail(f"phase 36: job {job} {op} ran in pid {pid}")
        for k, v in grew.items():
            if op in per_kernel:
                per_kernel[op][k] = per_kernel[op].get(k, 0) + v
    if any(ops.LAUNCHES.values()):
        fail(f"phase 36: the parent launched kernels: {ops.LAUNCHES}")
    for job, c in ctls.items():
        rec = billing[job]
        print(f"  bill {job}: busy {rec.busy_seconds} s, switch "
              f"{rec.switch_seconds} s, steps {rec.steps}; metrics "
              f"{c.metrics_log}")
        check_bill(cluster, rec, [c.dep.wpg], 1 + 2, 1)
        if not all(math.isfinite(v) for m in c.metrics_log
                   for v in m.values()):
            fail(f"phase 36: job {job}: non-finite metrics")
        del c.dep.wpg.execute            # the plain proxy from here on
        lay = child_layouts(gps[home[job]], c.dep.wpg.job_prefix)
        ids = list(slices[home[job]].device_ids())
        split = sum("model" in str(v["spec"]) for v in lay.values())
        if not lay or not split or any(
                v["ids"] != ids or v["devices"] != views[home[job]]
                or not v["replicas_same"] for v in lay.values()):
            fail(f"phase 36: job {job}'s entries are not laid out on its "
                 f"slice {ids}")
        print(f"  job {job}: {len(lay)} entries on slice {ids} in its child "
              f"({split} split over the slice)")
    # K1 and K2 at the per-device shapes the children ran them at, held
    # against their plain versions and timed here: the generate's prefill
    # at the prompt, its last decode step, the training forward over the
    # packed sequence; each row gets the children's launches at its shape
    kgen = torch.Generator(device=dev).manual_seed(36)

    def randn(*shape):
        return torch.randn(shape, generator=kgen,
                           device=dev).to(torch.bfloat16)

    h, kh = H // n, KH // n
    p_len, t_cap = TRAIN["prompt_len"], TRAIN["prompt_len"] + n_new
    fa, de = records["flash_attention"], records["decode_attention"]
    with step("K1 and K2 at the children's per-device shapes"):
        fa["proc_tp_prefill"] = flash_timing(torch, randn, B, p_len, h, kh,
                                             D)
        fa["proc_tp_training"] = flash_timing(torch, randn, B,
                                              TRAIN["seq_len"], h, kh, D)
        de["proc_tp_decode"] = decode_timing(torch, randn, B, t_cap,
                                             t_cap - 1, 500, h, kh, D)
    for rec, row, op, k in (
            (fa, "proc_tp_prefill", "generate", "flash_attention"),
            (fa, "proc_tp_training", "update_actor", "flash_attention"),
            (de, "proc_tp_decode", "generate", "decode_attention")):
        rec[row]["launches"] = per_kernel[op][k]
        rec["max_abs_err"] = max(rec["max_abs_err"], rec[row]["max_abs_err"])

    # a greedy generate in a child, then the teacher-forced FORWARD of its
    # tokens (the log-softmax of the logits at each next token), against
    # the same two ops in thread mode on the same slice
    pcut = PROC_TP_PARITY_OVERRIDES
    pcfg = get_config(ARCH).replace(**dict(pcut))
    pspec = api.DeploymentSpec(deployment_id="R-roll", job_id="R",
                               model_name=ARCH, role="rollout",
                               overrides=pcut)
    prompt = prompts(2, 64)
    pwant = {"generate": slice_launches(pcfg, "generate",
                                        PROC_TP_PARITY_NEW, n),
             "forward": slice_launches(pcfg, "forward", 0, n)}

    def generate_and_forward(d, counted):
        gen_out = counted(lambda: d.generate(
            prompt, max_new_tokens=PROC_TP_PARITY_NEW, temperature=0.0),
            "generate")
        seq = torch.cat([prompt, gen_out["tokens"].cpu()], 1)
        lp = counted(lambda: d.forward({"tokens": seq.numpy().astype(
            np.int32)}), "forward")
        return gen_out["tokens"].cpu(), lp.float().cpu()

    with step("a child's generate and forward against thread mode"):
        dep = router.deploy(pspec, group_id=0)
        run(dep.init(seed=5))
        child = generate_and_forward(dep, lambda f, op: (
            counted_op(gps[0], f, f"a greedy {op} at {pcfg.num_layers} "
                       f"layers, B=2 prompt 64", pwant[op])[0]))
        router.teardown("R-roll")
        tr = Router(device_plane=slice_plane(dev, n))
        tdep = tr.deploy(pspec, group_id=0)
        tdep.init(seed=5)
        tr.drain()
        tl = {}

        def thread_counted(f, op):
            ops.reset_launches()
            fut = f()
            tr.drain()
            tl[op] = dict(ops.LAUNCHES)
            return fut.result()

        thread = generate_and_forward(tdep, thread_counted)
        del tdep, tr
        release(torch, dev, "the thread-mode router")
    rel_tol = 2.0 ** -6 * math.sqrt(pcfg.num_layers / 4)
    err = (child[1] - thread[1]).abs().max().item()
    tol = rel_tol * thread[1].abs().max().item()
    same = torch.equal(child[0], thread[0])
    print(f"  thread mode: launches {tl}; tokens equal {same}; the forward's "
          f"logprobs |diff| {err} (bound {tol}: phase 5's {rel_tol} * "
          f"max|logprob|), bit-identical {torch.equal(child[1], thread[1])}")
    if tl != pwant or not same or not err <= tol:
        fail("phase 36: the child's generate parts from thread mode's")

    # job A's train state into group 1's child, resharded there
    a_prefix = ctls["A"].dep.wpg.job_prefix
    with step("digest job A's entries in group 0's child"):
        before = child_layouts(gps[0], a_prefix, digests=True)
    nbytes = router.state_managers[0].job_bytes(a_prefix)
    with step("migrate job A into the other child"):
        moved = cluster.reassign_job("A", 1)
    lm = dict(router.state_managers[0].last_migrate)
    with step("digest them in group 1's child"):
        after = child_layouts(gps[1], a_prefix, digests=True)
    here = StateManager(mesh_slice=slices[1])
    bad = [k for k, v in before.items() if after.get(k, {}).get("digest")
           != v["digest"] or after[k]["ids"] != list(slices[1].device_ids())
           or tuple(after[k]["spec"]) != tuple(here._layout_here(
               shd.NamedSharding(slices[0].mesh, shd.P(*v["spec"])),
               torch.Size(v["shape"])).spec)]
    route = "spill" if lm["spilled"] else "shm" if lm["shm"] else "pickle"
    rate = moved / lm["seconds"] / 1e9
    print(f"  reassign_job(A, 1): {moved} B in {lm['seconds']} s ({rate} "
          f"GB/s; export {lm['export_seconds']} s, "
          f"import {lm['import_seconds']} s), {lm['keys']} entries over "
          f"{route}, cross_mesh {lm['cross_mesh']}; entries bit-exact and "
          f"in the target slice's layout: {len(before) - len(bad)} of "
          f"{len(before)}")
    if moved != nbytes or not lm["cross_mesh"] or bad or \
            not router.migrate_log[-1]["cross_mesh"] or \
            router.state_managers[0].job_bytes(a_prefix):
        fail(f"phase 36: job A's move into group 1's child: {bad[:5]}")
    with step("a generate of job A on its new slice"):
        counted_op(gps[1], lambda: ctls["A"].dep.generate(
            prompts(B, TRAIN["prompt_len"]), max_new_tokens=n_new),
            "job A's generate in group 1's child", want["generate"])

    # SYNC_WEIGHTS from group 1's child into a rollout deployment of job A
    # in group 0's child that holds no parameters, in the rules' layout
    # over group 0's slice, built in this process
    roll = router.deploy(api.DeploymentSpec(
        deployment_id="A-roll", job_id="A", model_name=ARCH, role="rollout",
        overrides=cut), group_id=0)
    targets = tstate.shardings(build_model(cfg), slices[0].mesh,
                               shd.named_rules("tp")).params
    with step("SYNC_WEIGHTS across children into target shardings"):
        synced = run(ctls["A"].dep.sync_weights(roll,
                                                target_shardings=targets))
    src = {k.split("/params/")[1]: v for k, v in
           child_layouts(gps[1], a_prefix, True).items() if "/params/" in k}
    dst = {k.split("/params/")[1]: v for k, v in
           child_layouts(gps[0], roll.wpg.job_prefix, True).items()}
    tflat = common.canonical_flat(targets)
    bad = [k for k in src if dst.get(k, {}).get("digest") != src[k]["digest"]
           or tuple(dst[k]["spec"]) != tuple(tflat[k].spec)
           or dst[k]["ids"] != list(slices[0].device_ids())]
    print(f"  sync: {synced['synced_bytes']} B in "
          f"{ctls['A'].dep.wpg.exec_log[-1][1]} s; {len(src) - len(bad)} of "
          f"{len(src)} leaves bit-exact in the target shardings on slice "
          f"{slices[0].device_ids()}")
    if bad or src.keys() != dst.keys():
        fail(f"phase 36: the cross-process sync: {bad[:5]}")
    router.teardown("A-roll")

    # a PPO job (actor and critic) on group 0, one step
    with step("a PPO job's step in group 0's child"):
        ppo = cluster.add_job(JobConfig(job_id="P", model_name=ARCH, seed=3,
                                        overrides=cut, **train),
                              group_id=0, algo="ppo")
        plog = []
        for d in (ppo.dep, ppo.critic):
            counted_in_child(d.wpg, d.deployment_id, plog)
        billing = cluster.run(interleave=True)
    for dep_id, op, sec, grew, pid in plog:
        print(f"  {dep_id} {op}: {sec} s, launches {grew}")
        if grew != want[op] or pid != gps[0].pid():
            fail(f"phase 36: {dep_id} {op} launched {grew} in pid {pid}")
    rec = billing["P"]
    print(f"  bill P: busy {rec.busy_seconds} s, steps {rec.steps}; "
          f"metrics {ppo.metrics_log}")
    check_bill(cluster, rec, [ppo.dep.wpg, ppo.critic.wpg], 2 + 8, 1)
    m = ppo.metrics_log[0]
    if not {"pg_loss", "value_loss", "step"} <= m.keys() or \
            not all(math.isfinite(v) for v in m.values()):
        fail(f"phase 36: the PPO step's metrics {m}")
    for d in (ppo.dep, ppo.critic):
        del d.wpg.execute

    # OPTIM_STEP(host=True) over the slice: a train deployment of job H in
    # group 0's child and one in thread mode on a slice of this process,
    # INITed from one seed (the same bits); one FORWARD_BACKWARD in the
    # child, whose gradients cross the pipe whole; the host step on each
    # (thread mode's gradients laid out on its slice) against one device's
    # host step from the same parameters and gradients
    hp = AdamWConfig()                  # the children's WPGs' defaults
    hspec = api.DeploymentSpec(deployment_id="H-train", job_id="H",
                               model_name=ARCH, role="train", overrides=cut)
    dep = router.deploy(hspec, group_id=0)
    h_prefix = dep.wpg.job_prefix
    run(dep.init(seed=7))
    batch = seeded_train_batch(lambda b: run(dep.forward(b)), B,
                               TRAIN["seq_len"], TRAIN["prompt_len"], 36)
    with step("FORWARD_BACKWARD in the child"):
        fb, _ = counted_op(gps[0], lambda: dep.forward_backward(batch),
                           "job H's forward_backward",
                           want["forward_backward"])
    grads = fb["grads"]
    with step("OPTIM_STEP(host=True) in the child"):
        res = run(dep.optim_step(grads, host=True))
    with step("read the child's parameters"):
        child_after = child_params(gps[0], dep.deployment_id)
        lay = child_layouts(gps[0], h_prefix)
    print(f"  the child's host step: {res}, {dep.wpg.exec_log[-1][1]} s")
    if not res.get("host") or any(
            not v["replicas_same"] for v in lay.values()) or any(
            v["tier"] != int(Tier.HOST) for k, v in lay.items()
            if "/params/" in k):
        fail("phase 36: the child's host step left replicas apart or "
             "parameters on the card")
    with step("prefetch and a generate in the child"):
        dep.wpg.ensure_resident()
        lay = child_layouts(gps[0], h_prefix)
        if any(v["tier"] != int(Tier.DEVICE) or v["devices"] != views[0]
               for v in lay.values()):
            fail("phase 36: the prefetch left an entry off the slice")
        counted_op(gps[0], lambda: dep.generate(
            prompts(B, TRAIN["prompt_len"]), max_new_tokens=n_new),
            "job H's generate after the host step", want["generate"])

    # the children close, both at once, while this process runs the same
    # step in thread mode and on one device
    probes = {g: gp.call("probe")[0] for g, gp in gps.items()}
    reserved = sum(p["cuda_reserved"] or 0 for p in probes.values())
    used_open = mem_used(torch, dev)
    procs = [gp._proc for gp in gps.values()]
    closer = concurrent.futures.ThreadPoolExecutor(len(gps))
    t_close = time.perf_counter()
    closed = [closer.submit(gp.shutdown) for gp in gps.values()]
    with step("the same INIT and host step in thread mode"):
        tw = WorkerProcessGroup(hspec, StateManager(
            node_id="phase36", mesh_slice=slice_plane(dev, n).slices()[0]))
        tw.execute(api.make_op(hspec, api.Op.INIT, 7))
        # copies: on the host a gathered leaf may be a block's own tensor
        params0 = common.tree_map(torch.clone, tw.host_params(),
                                  is_leaf=torch.is_tensor)
        tw.execute(api.make_op(hspec, api.Op.OPTIM_STEP, shd.device_put(
            grads, tw.param_shardings()), host=True))
    for k in tw.sm.keys_for(tw.job_prefix):
        e = tw.sm.entries[k]
        if isinstance(e.ref, shd.Sharded):
            first = {}
            for pos, t in enumerate(e.ref.locals):
                b = e.ref.sharding.block(pos, e.ref.dim())
                if b in first and not same_bytes(torch, t, first[b]):
                    fail(f"phase 36: thread mode's {k} replicas differ")
                first.setdefault(b, t)
    thread_after = common.canonical_flat(tw.host_params())
    with step("one device's host step"):
        # its moments on the card, as one device's optimizer makes them
        ref = StateManager(node_id="phase36-ref",
                           mesh_slice=MeshSlice(0, dev))
        ref.register(h_prefix, common.tree_map(
            lambda t: t.to(dev, copy=True), params0, is_leaf=torch.is_tensor))
        ref.register(h_prefix, {mom: common.tree_map(
            lambda t: torch.zeros(t.shape, dtype=torch.float32, device=dev),
            params0, is_leaf=torch.is_tensor) for mom in ("mu", "nu")},
            prefix="opt")
        ref.host_optimizer_step(h_prefix, grads, None, lr=hp.lr, b1=hp.b1,
                                b2=hp.b2, eps=hp.eps)
    want_p = common.canonical_flat(ref.gather(h_prefix, params0))
    start = common.canonical_flat(params0)
    worst = {"child": 0.0, "thread": 0.0}
    for k, w in want_p.items():
        for side, got in (("child", child_after[k]), ("thread",
                                                       thread_after[k])):
            worst[side] = max(worst[side], host_step_close(torch, got, w))
    moved_leaves = sum(not same_bytes(torch, w, start[k])
                       for k, w in want_p.items())
    same = all(same_bytes(torch, child_after[k], thread_after[k])
               for k in want_p)
    print(f"  host step against one device's: worst |diff| / bound "
          f"{worst} (rtol 2^-7 bf16, 1e-5 f32); {moved_leaves} of "
          f"{len(want_p)} leaves moved; child and thread mode bit-identical "
          f"{same}")
    if max(worst.values()) > 1.0 or not moved_leaves:
        fail(f"phase 36: the host step over the slice: {worst}")
    del tw, ref, params0, thread_after, child_after, grads, start, want_p

    for f in closed:
        f.result()
    closer.shutdown()
    router.close_processes()
    steps["close the children (beside the steps above)"] = \
        time.perf_counter() - t_close
    del cluster, router, ctls, ppo, dep, roll
    release(torch, dev, "phase 36's cluster and host-step WPGs")
    alive = [p.pid for p in procs if p.is_alive()]
    used1 = mem_used(torch, dev)
    print(f"  children's peaks "
          f"{({g: p['cuda_peak'] for g, p in probes.items()})} B, the "
          f"parent's {torch.cuda.max_memory_allocated(dev)} B; card memory in "
          f"use {used0} B before the phase, {used_open} B with the children "
          f"(their caching allocators {reserved} B), {used1} B after they "
          f"exit; children alive {alive}")
    if alive or used_open - used1 < reserved:
        fail("phase 36: the children's CUDA contexts were not released")
    print(f"  phase 36 sub-steps: {steps}")


def dp_mesh(dev, shape):
    """A mesh of ``shape`` over virtual devices of the one card:
    (data, model), or (pod, data, model)."""
    from repro_torch.launch.mesh import Mesh

    def grid(dims):
        return [grid(dims[1:]) for _ in range(dims[0])] if dims else dev

    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    return Mesh(grid(list(shape)), axes)


def dp_state(torch, model, params, mesh, rules, adamw):
    """A train state of copies of ``params`` in ``train_state.shardings``'
    layout on ``mesh`` (ZeRO-2 moments, zero)."""
    from repro_torch.models import sharding as shd
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_state as ts

    shs = ts.shardings(model, mesh, shd.named_rules(rules), zero=True)
    dev = mesh.flat_devices()[0]
    st = ts.TrainState(params, opt.init(params, adamw),
                       torch.zeros((), dtype=torch.int32, device=dev))
    return ts.TrainState(
        shd.device_put(st.params, shs.params),
        opt.AdamWState(*(shd.device_put(getattr(st.opt_state, f),
                                        getattr(shs.opt_state, f))
                         for f in ("step", "mu", "nu"))),
        shd.device_put(st.step, shs.step))


def dp_meta_counts(torch, model, batch_shape, rules):
    """The dry run's count of the (2, 2) update on ``meta``: one data row
    (``launch/dryrun.mesh_cell_args``), its totals times the rows."""
    from repro_torch.launch import dryrun, hlo_cost

    mesh = dp_mesh(torch.device("meta"), (2, 2))
    fn, args, _ = dryrun.mesh_cell_args(model, batch_shape, mesh, rules,
                                        False)
    with hlo_cost.Counter() as c:
        fn(*args)
    return dryrun_per_device(c.stats(), mesh.shape["model"])


def f32_lookup_mode(torch, shape):
    """A function mode under which a lookup of rows of a tensor of
    ``shape`` by integer indices sums its gradient in f32 (one rounding
    to the table's dtype at the end), where the index backward adds each
    use in the table's dtype: the witness's embedding gradient."""
    from torch.overrides import TorchFunctionMode

    class Lookup(torch.autograd.Function):
        @staticmethod
        def forward(ctx, table, idx):
            ctx.save_for_backward(idx)
            ctx.rows = table.shape[0]
            return table[idx]

        @staticmethod
        def backward(ctx, g):
            idx, = ctx.saved_tensors
            acc = torch.zeros((ctx.rows, g.shape[-1]), dtype=torch.float32,
                              device=g.device)
            acc.index_add_(0, idx.flatten(),
                           g.reshape(-1, g.shape[-1]).float())
            return acc.to(g.dtype), None

    class Mode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.__getitem__ and \
                    tuple(args[0].shape) == shape and \
                    torch.is_tensor(args[1]) and \
                    not args[1].is_floating_point():
                return Lookup.apply(*args)
            return func(*args, **(kwargs or {}))

    return Mode()


def dp_update(torch, dev, model, params, batch, one, rules, rows):
    """One update_actor of ``params`` on the (2, 2) mesh under ``rules``
    against ``one`` (the one-device witness's metrics, parameters and mu):
    phase 9's tolerances (``held_update``, the embedding's mu but for
    ``rows``), replicated blocks the same bits, each device's
    blocks those of the specs, K1 launched 2 x DP_LAYERS times on each
    device. Under ``tp`` the card's per-device counts must equal the dry
    run's on ``meta``, exactly. Returns the launches the update made."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import hlo_cost
    from repro_torch.models import common
    from repro_torch.models import sharding as shd
    from repro_torch.models.layers import make_ctx
    from repro_torch.rl import grpo
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_state as ts

    adamw = opt.AdamWConfig(**TRAIN_LR)
    mesh = dp_mesh(dev, (2, 2))
    ctx = make_ctx(mesh, rules)
    state = dp_state(torch, model, params, mesh, rules, adamw)
    step = grpo.make_update_actor(model, adamw=adamw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ops.reset_launches()
    with hlo_cost.Counter() as c:
        _, met = step(state, batch, ctx=ctx)
        got = dict(ops.LAUNCHES)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want = {"flash_attention": 4 * 2 * DP_LAYERS, "decode_attention": 0,
            "ssd": 0}
    print(f"  update_actor under {rules} on (2, 2): {secs} s, launches "
          f"{got}; { {k: float(v) for k, v in met.items()} }")
    if got != want:
        fail(f"phase 37: update_actor under {rules} launched {got}, want "
             f"{want}")
    specs = ts.partition_specs(model, mesh, shd.named_rules(rules))
    p2, mu2, pspec, mspec = (common.canonical_flat(t) for t in (
        state.params, state.opt_state.mu, specs.params, specs.opt_state.mu))
    worst = held_update(torch, met, p2, mu2, one, adamw, f"under {rules}",
                        rows)
    halves = held = want_bytes = 0
    for k, leaf in p2.items():
        for got_leaf, spec in ((leaf, pspec[k]), (mu2[k], mspec[k])):
            if tuple(got_leaf.sharding.spec) != tuple(spec):
                fail(f"phase 37: {k} laid out as {got_leaf.sharding.spec}, "
                     f"its spec {spec}")
            first = {}
            for pos, t in enumerate(got_leaf.locals):
                b = got_leaf.sharding.block(pos, got_leaf.dim())
                if b in first and not torch.equal(t, first[b]):
                    fail(f"phase 37: replicas of {k} differ under {rules}")
                first.setdefault(b, t)
        if "data" in str(tuple(mspec[k])) and \
                "data" not in str(tuple(pspec[k])):
            if mu2[k].locals[0].numel() * 2 != leaf.locals[0].numel():
                fail(f"phase 37: mu {k} is not half a device's block")
            halves += 1
        held += leaf.locals[0].numel() * leaf.element_size()
        want_bytes += leaf.numel() * leaf.element_size() // math.prod(
            leaf.sharding.parts(leaf.dim()))
    if held != want_bytes or not halves:
        fail(f"phase 37: a device holds {held} B of parameters, its specs "
             f"{want_bytes} B; {halves} moments halved")
    print(f"  under {rules}: metrics, mu and the parameters within phase "
          f"9's tolerances of the witness (worst |diff| / tolerance "
          f"{worst}); {halves} moments split over data, half a device; "
          f"{held} B of parameters a device, as the specs give")
    if rules == "tp":
        card = dryrun_per_device(c.stats(), 4)
        b, s = batch["tokens"].shape
        meta = dp_meta_counts(torch, model, ShapeSpec("t", "train", s, b),
                              rules)
        print(f"  counts a device, card {card}; meta {meta}")
        if card != meta:
            fail("phase 37: the card's per-device counts differ from the "
                 "dry run's on meta")
        print("  the card's counts a device equal the dry run's on meta "
              "exactly (FLOPs, bytes, ops, kernels, collectives by kind)")
    emb_mu = shd.gather(mu2["embed/embedding"])
    del state, p2, mu2
    return got, emb_mu


def held_update(torch, met, params, mu, one, adamw, what, rows):
    """The metrics, mu and the parameters (flat trees) of one update
    against ``one``'s (the witness): the metrics within 5e-2 (grad_norm
    5 %), each leaf's f32 mu within 5e-2 of its largest |mu| (phase 9's;
    the embedding's but for ``rows``, which the caller holds), and each
    parameter
    within 5e-2 of its leaf's largest where its gradient, on both sides, is
    clear of rounding (|mu| above 1e-3 of the leaf's largest) and of eps
    (|g| = 10 |mu| above 100 eps) and of one sign: AdamW's first step is
    lr * g / (|g| + eps), about lr * sign(g), and moves by up to 2 lr where
    a gradient in the rounding noise differs; mu, which carries it, is held
    whole. Returns the worst |diff| / tolerance."""
    from repro_torch.models import sharding as shd

    worst = 0.0
    for k in ("loss", "pg_loss", "kl", "aux", "grad_norm"):
        g, w = float(met[k]), float(one["metrics"][k])
        tol = 5e-2 * (w if k == "grad_norm" else max(1.0, abs(w)))
        worst = max(worst, abs(g - w) / tol)
        if not abs(g - w) <= tol:
            fail(f"phase 37: {k} {what} {g}, the witness {w}")
    for k, leaf in params.items():
        mu1 = one["mu"][k].float()
        mu_got = shd.gather(mu[k]).float()
        floor = torch.clamp(1e-3 * mu1.abs().max(), min=10 * adamw.eps)
        clear = (torch.sign(mu_got) == torch.sign(mu1)) & (
            mu1.abs() > floor) & (mu_got.abs() > floor)
        keep = ~rows if k == "embed/embedding" else slice(None)
        for name, got_t, ref_t in (
                ("param", shd.gather(leaf).float()[clear],
                 one["params"][k].float()[clear]),
                ("mu", mu_got[keep], mu1[keep])):
            if not ref_t.numel():
                continue
            err = (got_t - ref_t).abs().max().item()
            tol = 5e-2 * ref_t.abs().max().item()
            worst = max(worst, err / tol if tol else 0.0)
            if not err <= tol:
                fail(f"phase 37: {name} {k} {what}: {err} > {tol}")
    return worst


def dryrun_per_device(stats, n):
    """The counts ``launch/dryrun.py`` compares, over ``n`` devices."""
    from repro_torch.launch import dryrun

    return dryrun.per_device_counts(
        {k: stats[k] for k in ("flops", "traffic_bytes", "ops", "kernels",
                               "collectives")}, n)


def dp_phase(torch, dev, records):
    """Phase 37: the data and pod axes (module constants above). The
    update under ``tp`` and ``fsdp_tp``, a generate, a prefill over a pod
    axis and zamba2's context-parallel decode, each against one device;
    K1, K2 and K2 with its log-sum-exp at the per-device shapes against
    their plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import common
    from repro_torch.models import sharding as shd
    from repro_torch.models.layers import make_ctx, row_logits
    from repro_torch.models.registry import build_model
    from repro_torch.rl import grpo
    from repro_torch.rl import rollout
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_state as ts

    t_phase = time.monotonic()
    cfg = get_config(ARCH).replace(num_layers=DP_LAYERS)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(37)
    params = model.init_params(gen, dev)
    params["embed"]["embedding"].mul_(1 / 64)      # phase 9's spread policy
    b, s = TRAIN["batch_size"], TRAIN["seq_len"]
    logp = grpo.make_compute_log_prob(model)
    np_batch = seeded_train_batch(
        lambda bt: logp(params, {k: torch.from_numpy(v).to(dev)
                                 for k, v in bt.items()}),
        b, s, TRAIN["prompt_len"], 37)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()}
    print(f"phase 37: {ARCH} at full width, {DP_LAYERS} of 24 layers, on "
          f"(2, 2) data x model virtual devices; update_actor at B={b} "
          f"({b // 2} a row) S={s}, AdamW {TRAIN_LR}")
    adamw = opt.AdamWConfig(**TRAIN_LR)
    emb_shape = tuple(params["embed"]["embedding"].shape)
    ref = {}
    for name, mode in (("one device", contextlib.nullcontext()),
                       ("witness", f32_lookup_mode(torch, emb_shape))):
        clone = common.tree_map(lambda t: t.clone(), params,
                                is_leaf=torch.is_tensor)
        one = ts.TrainState(clone, opt.init(clone, adamw),
                            torch.zeros((), dtype=torch.int32, device=dev))
        with mode:
            _, m1 = grpo.make_update_actor(model, adamw=adamw)(one, batch)
        ref[name] = {"metrics": {k: float(v) for k, v in m1.items()},
                     "params": common.canonical_flat(one.params),
                     "mu": common.canonical_flat(one.opt_state.mu)}
        print(f"  {name}: {ref[name]['metrics']}")
        del one, clone
    # the witness is the one-device update with the embedding lookup's
    # gradient summed in f32 (a token used n times in the batch adds n bf16
    # rows in the index backward). Both updates are held against it within
    # phase 9's tolerances, but for the embedding's mu rows where the
    # one-device update misses it by more (``rows``, the index backward's
    # rounding): there the mesh, whose data rows each sum a part of the
    # uses, must be no farther from the witness than one device is
    wit, one = ref["witness"], ref["one device"]
    uses = torch.bincount(batch["tokens"].flatten().long(),
                          minlength=emb_shape[0])
    mu_w, mu_1 = (r["mu"]["embed/embedding"].float() for r in (wit, one))
    scale = mu_w.abs().max().item()
    err_1 = (mu_1 - mu_w).abs().amax(1)
    rows = err_1 > 5e-2 * scale
    idx = rows.nonzero().flatten()
    print(f"  the embedding's mu, one device against the witness: "
          f"{int(rows.sum())} rows beyond 5e-2 of the leaf's largest (tokens "
          f"{idx.tolist()[:8]}, uses {uses[idx].tolist()[:8]}), worst "
          f"{err_1.max().item() / scale} of the leaf's largest")
    worst = held_update(torch, one["metrics"], one["params"], one["mu"],
                        wit, adamw, "on one device", rows)
    print(f"  the one-device update within phase 9's tolerances of the "
          f"witness but for those rows (worst |diff| / tolerance {worst})")
    upd = {}
    for rules in ("tp", "fsdp_tp"):
        upd[rules], mu_r = dp_update(torch, dev, model, params, batch, wit,
                                     rules, rows)
        err_r = (mu_r.float() - mu_w).abs().amax(1)
        print(f"  the embedding's mu under {rules} against the witness: "
              f"worst {err_r.max().item() / scale} of the leaf's largest; "
              f"in those rows {(err_r[idx] / scale).tolist()[:8]}, one "
              f"device {(err_1[idx] / scale).tolist()[:8]}")
        if not bool((err_r[rows] <= err_1[rows]).all()):
            fail(f"phase 37: the embedding's mu under {rules} is farther "
                 f"from the witness than one device's in the rows where "
                 f"one device misses it")
    del ref, wit, one, mu_w, mu_1
    release(torch, dev, "phase 37's train states")

    # a generate on (2, 2): the prefill and 64 decode steps, each step's
    # logits against one device's, both fed the one device's argmax; the
    # launches counted from 0 over each call on the mesh and summed
    mesh = dp_mesh(dev, (2, 2))
    ctx = make_ctx(mesh, "tp")
    sp = shd.device_put(params, shd.tree_shardings(
        model.logical_axes(), mesh, ctx.rules, model.param_specs()))
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device=dev)
    rel_tol = 2.0 ** -6 * math.sqrt(DP_LAYERS / 4)
    worst = 0.0
    gen_k = dict.fromkeys(ops.LAUNCHES, 0)

    def held(got, want, what):
        nonlocal worst
        err = (got.float() - want.float()).abs().max().item()
        tol = rel_tol * want.float().abs().max().item()
        worst = max(worst, err / tol)
        if not (torch.isfinite(got).all() and err <= tol):
            fail(f"phase 37: {what}: max|diff| {err} > {tol}")

    def on_mesh(fn, *args, **kw):
        ops.reset_launches()
        out = fn(*args, **kw)
        for k, v in ops.LAUNCHES.items():
            gen_k[k] += v
        return out

    with torch.no_grad():
        lp, _, cp = on_mesh(model.forward, sp, {"tokens": prompt},
                            return_cache=True, ctx=ctx)
        prefill_k = dict(gen_k)
        l1, _, c1 = model.forward(params, {"tokens": prompt},
                                  return_cache=True)
        held(row_logits(ctx, lp, B), l1, "prefill logits on (2, 2)")
        cp, c1 = rollout._pad_cache(cp, N_NEW), rollout._pad_cache(c1, N_NEW)
        tok = l1[:, -1:].argmax(-1)
        for i in range(N_NEW):
            lp, cp = on_mesh(model.decode_step, sp, cp, {"tokens": tok},
                             ctx=ctx)
            l1, c1 = model.decode_step(params, c1, {"tokens": tok})
            held(row_logits(ctx, lp, B), l1, f"decode step {i} on (2, 2)")
            tok = l1.argmax(-1)
    want = {"flash_attention": 4 * DP_LAYERS,
            "decode_attention": 4 * DP_LAYERS * N_NEW, "ssd": 0}
    print(f"  a generate on (2, 2), B={B} prompt {P}, {N_NEW} decode steps: "
          f"logits within phase 5's bound of one device (worst |diff| / "
          f"tolerance {worst}); the mesh's launches {gen_k}")
    if gen_k != want or prefill_k["decode_attention"]:
        fail(f"phase 37: the generate on (2, 2) launched {gen_k}, want {want}")
    del sp, cp, c1
    # a prefill over the pod axis: (2, 1, 2), DP_POD_LAYERS layers
    cut = {k: v for k, v in params.items()}
    cut["layers"] = {k: v for k, v in common.tree_map(
        lambda t: t[:DP_POD_LAYERS], params["layers"],
        is_leaf=torch.is_tensor).items()}
    pod_model = build_model(cfg.replace(num_layers=DP_POD_LAYERS))
    pmesh = dp_mesh(dev, (2, 1, 2))
    pctx = make_ctx(pmesh, "tp")
    pp = shd.device_put(cut, shd.tree_shardings(
        pod_model.logical_axes(), pmesh, pctx.rules,
        pod_model.param_specs()))
    with torch.no_grad():
        ops.reset_launches()
        lp, _ = grpo.make_prefill(pod_model)(pp, {"tokens": prompt},
                                             ctx=pctx)
        pod_k = dict(ops.LAUNCHES)
        l1, _ = grpo.make_prefill(pod_model)(cut, {"tokens": prompt})
    worst = 0.0
    held(row_logits(pctx, lp, B), l1, "prefill on (2, 1, 2)")
    print(f"  a prefill on (2, 1, 2) pod x data x model at {DP_POD_LAYERS} "
          f"layers: logits within phase 5's bound of one device (worst "
          f"{worst}); launches {pod_k}")
    if pod_k != {"flash_attention": 4 * DP_POD_LAYERS, "decode_attention": 0,
                 "ssd": 0}:
        fail(f"phase 37: the pod prefill launched {pod_k}")
    del pp, cut, params
    release(torch, dev, "phase 37's qwen2 parameters")

    # zamba2's context-parallel decode under long: (2, 2), B=1
    hcfg = get_config(HYB_ARCH).replace(num_layers=DP_HYB_LAYERS)
    hm = build_model(hcfg)
    hp = hm.init_params(gen, dev)
    hprompt = torch.randint(0, hcfg.vocab_size, (1, DP_CP_P), generator=gen,
                            device=dev)
    with torch.no_grad():
        _, _, hc = hm.forward(hp, {"tokens": hprompt}, return_cache=True)
        hc = rollout._pad_cache(hc, DP_CP_T - DP_CP_P)
        lctx = make_ctx(mesh, "long")
        hsp = shd.device_put(hp, shd.tree_shardings(
            hm.logical_axes(), mesh, lctx.rules, hm.param_specs()))
        specs = hm.cache_specs(1, DP_CP_T)
        hcp = dict(shd.device_put(
            {k: v for k, v in hc.items() if k != "pos"},
            shd.tree_shardings(common.logical_axes(specs), mesh, lctx.rules,
                               specs)), pos=DP_CP_P)
        if hcp["attn_k"].locals[0].shape[2] != DP_CP_T // 2:
            fail("phase 37: zamba2's cache is not split over data")
        tok = torch.randint(0, hcfg.vocab_size, (1, 1), generator=gen,
                            device=dev)
        ops.reset_launches()
        lcp, _ = hm.decode_step(hsp, hcp, {"tokens": tok}, ctx=lctx)
        cp_k = dict(ops.LAUNCHES)
        l1, _ = hm.decode_step(hp, hc, {"tokens": tok})
    worst = 0.0
    rel_tol = 2.0 ** -6 * math.sqrt(DP_HYB_LAYERS / 4)
    held(row_logits(lctx, lcp, 1), l1, "zamba2's context-parallel decode")
    want = {"flash_attention": 0, "ssd": 0,
            "decode_attention": 4 * (DP_HYB_LAYERS // hcfg.attn_period)}
    print(f"  zamba2-7b at {DP_HYB_LAYERS} blocks, B=1, a cache of "
          f"{DP_CP_T} slots split over data = 2 at pos {DP_CP_P}: one "
          f"decode step's logits within phase 5's bound of one device "
          f"(worst {worst}); launches {cp_k} (K2 with its log-sum-exp, each "
          f"device over its {DP_CP_T // 2} keys)")
    if cp_k != want:
        fail(f"phase 37: the context-parallel decode launched {cp_k}")
    del hsp, hcp, hc, hp
    release(torch, dev, "phase 37's zamba2")

    # the kernels at the per-device shapes: K1 (the update's and the
    # prefill's B=8 S=128), K2 (the decode's B=8 T=192), K2 with its
    # log-sum-exp (the context-parallel decode's B=1 T=4096 H=K=16 D=112),
    # each with the launches counted on the mesh above
    k1_launches = sum(k["flash_attention"]
                      for k in (upd["tp"], upd["fsdp_tp"], gen_k, pod_k))
    slice_kernel_rows(torch, dev, records, (
        ("flash_attention", "dp_2x2", flash_timing,
         (B // 2, P, H // 2, KH // 2, D), k1_launches),
        ("decode_attention", "dp_2x2", decode_timing,
         (B // 2, P + N_NEW, P + N_NEW - 1, 200, H // 2, KH // 2, D),
         gen_k["decode_attention"]),
    ))
    gen33 = torch.Generator(device=dev).manual_seed(37)

    def randn(*shape):
        return torch.randn(shape, generator=gen33,
                           device=dev).to(torch.bfloat16)

    rec = decode_lse_timing(torch, randn, 1, DP_CP_T // 2, DP_CP_T // 2 - 1,
                            HYB_H // 2, HYB_H // 2, HYB_D)
    rec["launches"] = cp_k["decode_attention"]
    records["decode_attention"]["dp_cp_lse"] = rec
    records["decode_attention"]["max_abs_err"] = max(
        records["decode_attention"]["max_abs_err"], rec["max_abs_err"])
    print(f"  phase 37 aimed at 45 s, took {time.monotonic() - t_phase} s")


def decode_lse_timing(torch, randn, b, t_cap, pos, h, kh, d, iters=200):
    """K2 with its log-sum-exp output at one shape, against its plain
    version (the output within the bf16 tolerance, the f32 lse within
    1e-2), timed beside its bound (the lse's 4 B a row written too) and
    SDPA (which computes the output alone)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import bound

    flops, per_call = ops.decode_attention_work(b, h, kh, d, pos, 2, 2,
                                                lse=True)
    sets = [(Q_SCALE * randn(b, h, d), randn(b, t_cap, kh, d),
             randn(b, t_cap, kh, d)) for _ in range(n_sets(per_call))]
    q, kc, vc = sets[0]
    shape = f"B={b} T={t_cap} H={h} K={kh} D={d} pos={pos} with lse"
    out, lse = ops.decode_attention(q, kc, vc, pos, return_lse=True)
    r_out, r_lse = ref.ref_decode_attention(q, kc, vc, pos, return_lse=True)
    err = check_close(torch, shape, out, r_out)
    lse_err = (lse - r_lse).abs().max().item()
    print(f"  {shape}: lse max_abs_err {lse_err} (tolerance 1e-2)")
    if not (lse.dtype == torch.float32 and lse_err <= 1e-2):
        fail(f"K2's lse at {shape}: max|diff| {lse_err}")
    # a block past the position: no live key, lse -inf and an output of 0
    e_out, e_lse = ops.decode_attention(q, kc, vc, -1, return_lse=True)
    if not (torch.all(e_lse == float("-inf")) and torch.all(e_out == 0)):
        fail("K2 with no live key did not give -inf and zeros")

    def kernel(q, k, v):
        return ops.decode_attention(q, k, v, pos, return_lse=True)

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q[:, :, None], k[:, :pos + 1].transpose(1, 2),
            v[:, :pos + 1].transpose(1, 2), enable_gqa=True)[:, :, 0]

    library.label = "sdpa"
    reps = max(50, 1000 // len(sets))
    t_kernel = time_ms(torch, kernel, sets, iters)
    t_plain = time_ms(torch, lambda q, k, v: ref.ref_decode_attention(
        q, k, v, pos, return_lse=True), sets, iters // 5)
    d_kernel = device_ms(torch, kernel, sets, reps)
    t_lib, d_lib = library_times(torch, library, sets, iters, reps)
    t_bound, by = bound(per_call, flops)
    print(f"  timing {shape}: kernel {t_kernel} ms (device {d_kernel} ms), "
          f"plain {t_plain} ms, sdpa {t_lib} ms (device {d_lib} ms), bound "
          f"{t_bound} ms ({by}: {per_call} B, {flops} FLOP)")
    return dict(shape=shape, max_abs_err=max(err, lse_err), ms=t_kernel,
                device_ms=d_kernel, plain_ms=t_plain, bound_ms=t_bound,
                bound_by=by, library_ms=t_lib, library_device_ms=d_lib,
                library="sdpa")


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


def cut_parity_phase(torch, dev, phase, arch, layers):
    """Phase 5's parity for ``arch`` at full width, cut to ``layers``
    layers or blocks (depth only) for the CPU side, from the port's seeded
    init."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    model = build_model(get_config(arch).replace(num_layers=layers))
    params = model.init_params(torch.Generator(device=dev).manual_seed(1),
                               dev)
    return parity_phase(torch, model, params, dev, phase)


T_START = time.monotonic()


@contextlib.contextmanager
def phase_seconds(name):
    """Print the seconds the phase (or phases) ``name`` took, and its start
    to the standard error, so a run stopped from outside shows how far it
    got."""
    t0 = time.monotonic()
    print(f"chip_smoke: {name} starts at {t0 - T_START:.1f} s",
          file=sys.stderr, flush=True)
    yield
    print(f"{name} took {time.monotonic() - t0} s", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    sys.stdout.reconfigure(line_buffering=True)   # a stopped run shows its end
    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"phase 1: card {card}")
    with phase_seconds("phase 2"):
        warm = flex_warmup(torch, dev)
        build.load()
        print(f"phase 2: kernels built (nvcc {build.build_seconds} s; None "
              f"= cached)")
        build_report(build)
        cluster_report()
    with phase_seconds("phase 3"):
        warm.join()
        records = kernel_phase(torch, dev)
        records.update(ssd_kernel_phase(torch, dev))

    want = {"flash_attention": LAYERS, "decode_attention": LAYERS * N_NEW,
            "ssd": 0}
    with phase_seconds("phase 4"):
        router, launches = serve_phase(torch, dev, 4, ARCH, P, want)
        path_launches(records, launches, want)
    with phase_seconds("phase 5"):
        wpg = router.wpgs["rollout-A"]
        parity_phase(torch, wpg.model, wpg.params(), dev, 5)
        # release the qwen2 deployments (device and pinned host memory)
        del router, wpg
        release(torch, dev, "qwen2 router")

    cut = (("num_layers", SSM_LAYERS),)
    want = {"flash_attention": 0, "decode_attention": 0, "ssd": SSM_LAYERS}
    with phase_seconds("phase 6"):
        router, launches = serve_phase(torch, dev, 6, SSM_ARCH, SSM_P, want,
                                       overrides=cut)
        path_launches(records, launches, want)
    with phase_seconds("phase 7"):
        del router
        release(torch, dev, "mamba2 router")
        cut_parity_phase(torch, dev, 7, SSM_ARCH, SSM_PARITY_LAYERS)

    with phase_seconds("phase 8"):
        cluster = train_phase(torch, dev, records)
        del cluster
        release(torch, dev, "training cluster")
    with phase_seconds("phase 9"):
        train_parity_phase(torch, dev)
        release(torch, dev, "training parity WPGs")

    # zamba2: all three kernels on one path, at full width
    cut = (("num_layers", HYB_LAYERS),)
    want = launches_per_op(get_config(HYB_ARCH).replace(**dict(cut)),
                           "generate", N_NEW)
    with phase_seconds("phase 10"):
        router, launches = serve_phase(torch, dev, 10, HYB_ARCH, HYB_P, want,
                                       overrides=cut)
        path_launches(records, launches, want, "zamba2")
        del router
        release(torch, dev, "zamba2 router")
    with phase_seconds("phase 11"):
        cut_parity_phase(torch, dev, 11, HYB_ARCH, HYB_PARITY_LAYERS)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with phase_seconds("phase 12"):
            train_cli_phase(records, tmp)
        with phase_seconds("phase 13"):
            control_plane_phase(torch, dev, records)
            release(torch, dev, "control-plane cluster")

        with phase_seconds("phase 14"):
            cluster = pinned_train_phase(torch, dev, records, 14, SSM_ARCH,
                                         SSM_TRAIN_LAYERS)
            del cluster
            release(torch, dev, "mamba2 training cluster")
        with phase_seconds("phase 15"):
            ssm_parity_phase(torch, dev, records)
        with phase_seconds("phase 16"):
            ppo_phase(torch, dev, records)
            release(torch, dev, "host-step WPG")
        with phase_seconds("phase 17"):
            checkpoint_phase(torch, dev, tmp)
            release(torch, dev, "checkpoint cluster")
        with phase_seconds("phase 18"):
            proc_phase(torch, dev, records, tmp)
            release(torch, dev, "process-plane cluster")

        with phase_seconds("phase 19"):
            router = moe_serve_phase(torch, dev, records)
            del router
            release(torch, dev, "MoE router")
        with phase_seconds("phase 20"):
            moe_parity_phase(torch, dev)
            release(torch, dev, "MoE parity parameters")
        with phase_seconds("phase 21"):
            cluster = pinned_train_phase(torch, dev, records, 21,
                                         GRANITE_ARCH, GRANITE_LAYERS)
            del cluster
            # the granite rows' launches: 4 generates and 4 update_actors
            for name, row, op in (("flash_attention", "granite_prefill",
                                   "per_generate"),
                                  ("flash_attention", "granite_training",
                                   "per_update_actor"),
                                  ("decode_attention", "granite",
                                   "per_generate")):
                records[name][row]["launches"] = 2 * TRAIN["steps"] * \
                    records[name]["train_launches"][GRANITE_ARCH][op]
            release(torch, dev, "granite training cluster")
        with phase_seconds("phase 22"):
            update_parity(torch, dev, 22, GRANITE_ARCH,
                          (("num_layers", PARITY_LAYERS),))
            release(torch, dev, "granite parity WPGs")

        with phase_seconds("phase 23"):
            router = gemma2_serve_phase(torch, dev, records)
            del router
            release(torch, dev, "gemma2 router")
        with phase_seconds("phase 24"):
            gemma2_parity_phase(torch, dev)
            release(torch, dev, "gemma2 parity parameters")

        with phase_seconds("phase 25"):
            router = whisper_serve_phase(torch, dev, records)
            del router
            release(torch, dev, "whisper router")
        with phase_seconds("phase 26"):
            whisper_parity_phase(torch, dev)
            release(torch, dev, "whisper parity parameters")

        with phase_seconds("phase 27"):
            router = vision_serve_phase(torch, dev, records)
            del router
            release(torch, dev, "vision router")
        with phase_seconds("phase 28"):
            vision_parity_phase(torch, dev)
            release(torch, dev, "vision parity parameters")

        with phase_seconds("phase 29"):
            cost_phase(torch, dev, card)
            release(torch, dev, "cost-model steps")
        with phase_seconds("phase 30"):
            examples_phase(torch, tmp, records)
            release(torch, dev, "examples")
        with phase_seconds("phase 31"):
            offset_phase(torch, dev, records)
            release(torch, dev, "multi-token cache writes")
        with phase_seconds("phase 32"):
            tp_phase(torch, dev, records)
        with phase_seconds("phase 33"):
            ep_phase(torch, dev, records)
        with phase_seconds("phase 34"):
            ssm_tp_phase(torch, dev, records)
        with phase_seconds("phase 35"):
            xattn_tp_phase(torch, dev, records)
        with phase_seconds("phase 36"):
            proc_tp_phase(torch, dev, records)
        with phase_seconds("phase 37"):
            dp_phase(torch, dev, records)
            release(torch, dev, "phase 37")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"all phases passed in {time.monotonic() - t_start} s")
    print(card)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
