"""Two RLVR jobs multiplexed on a shared pool — the paper's core claim,
executed for real on this machine.

Part 1 (one group, HRRS mechanism): the same two jobs run
  (a) isolated   — back-to-back on the pool (job-local reservation)
  (b) multiplexed— PlexRL interleaves them with HRRS + StateManager swaps
and compares wall-clock + billed GPU-seconds per step.

Part 2 (two groups, concurrent dispatch plane): the same two jobs, one per
node group, run
  (c) serial     — the serial driver executes every admitted op inline,
                   so job A's rollout blocks job B's training functions
  (d) concurrent — Router.run_until_idle dispatches each group on its own
                   worker thread; job A's rollout overlaps job B's
                   update_actor in measured wall-clock time (PyTorch's
                   kernels release the GIL while executing).

Part 3 (serve mode, the paper's §4.1 regime): the plane runs PERSISTENTLY
(`PlexCluster.serve()`), each job self-drives on its own client thread
through the dataflow API (Deployment handles + `.then` chains — see
core/controller.py for the straight-line GRPO and split-op PPO loops), and
jobs ARRIVE and LEAVE against the live service: a GRPO job starts, a PPO
job attaches mid-flight on a fresh node group (its dispatch worker spawns
dynamically), a third job detaches with work still queued — queued ops
cancel, in-flight ops resolve, and billing stays incremental throughout.

Part 4 (auto-placement + autoscale, §4.3-§4.4): jobs are added with
`group_id=None`, so the cluster CONTROL PLANE decides where they run. Each
arrival is cold-placed on a dedicated profiling group (spawned on demand),
the online profiler folds the executor's per-op task records into its
JobTrace, and after the warmup cycle the job is re-fitted by micro-shift
trace fitting — live-migrating onto a shared group (admission hold ->
in-flight drain -> StateManager.migrate -> queued-op rehome) while the
drained profiling group is retired. A later arrival finds no clean group
and triggers a capacity-adjustment spawn. The director's decision log
prints at the end.

Part 5 (continuous reconciliation, §4.3.2's repacking loop — scripted on a
VirtualClock so every decision is deterministic): two jobs consolidate onto
one group, then one job's ROLLOUT PHASE DOUBLES mid-run (response lengths
grow as the policy improves). The reconciler compares the rolling profile
against the placed trace, detects the drift, re-profiles, re-fits — the
grown cycle no longer coexists with its neighbour — spawns a group and
live-migrates, with the whole detect -> re-profile -> repack -> migrate
sequence in the director's decision log.

Part 6 (multi-tenant service layer): the plane serves two TENANTS — a
GUARANTEED "prod" tenant with an SLO and a BEST_EFFORT "lab" tenant with a
1-job group quota. A second lab submission is admission-QUEUED at quota
(typed denial, not a stack trace), the operator TIGHTENS prod's SLO
mid-serve (re-registering the spec), the next folded steps breach the
rolling p95 and the director's fourth trigger preempts/holds the
best-effort job, and detaching the first lab job drains the queued one in.
Decision log and per-tenant accounting print at the end.

The port of ``examples/multiplex_rlvr.py``, at its sizes and head width
(12: K1 and K2 pad it to 16 on the card). Every cluster and router gets a
device plane over ``device`` (None: the CUDA card); ``run(...)`` and the
parts are importable.

Part 6 differs from the reference in three settings, so that the director
packs both tenants' jobs onto one group, where trigger 4 can then preempt
or hold the best-effort one. The director drops each job's first cycle
from its profile (``warmup_cycles=1``, the default): in a fresh process
that cycle's ``update_actor`` carries one-time costs (the first
rematerialised backward), which make the job look update-bound. And each
step generates ``P6_NEW_TOKENS`` tokens, not 6, so a step's rollout, which
the placement counts as the group's free time, outweighs its update: two
jobs whose updates fill less than half their cycles fit on one group.
Once packed, the jobs' shared group stretches both their cycles; a drift
ratio of 4 (not 1.5) keeps that from reading as phase drift, which would
re-fit them apart. The reference's first, compiled cycle is rollout-bound,
which is why it packs the two jobs with the first cycle kept.

Run:  PYTHONPATH=src python -m repro_torch.examples.multiplex_rlvr [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import api, tenancy
from repro_torch.core.cluster import PlexCluster
from repro_torch.core.control_plane import DirectorConfig, PlacementDirector
from repro_torch.core.controller import JobConfig
from repro_torch.core.router import Router
from repro_torch.core.scheduler.executor import VirtualClock
from repro_torch.launch.mesh import DevicePlane

TINY = (("num_layers", 2), ("d_model", 48), ("num_heads", 4),
        ("num_kv_heads", 2), ("head_dim", 12), ("d_ff", 96),
        ("vocab_size", 64), ("tie_embeddings", True), ("attn_q_chunk", 32))


# Part 6's tokens generated a step: enough that a step's rollout outweighs
# its update on the CPU and on the card (module docstring)
P6_NEW_TOKENS = 48


def make_jobs():
    return [
        JobConfig(job_id="alpha", model_name="qwen2-0.5b", steps=3,
                  batch_size=8, group_size=4, max_new_tokens=6, seq_len=32,
                  overrides=TINY, seed=1),
        JobConfig(job_id="beta", model_name="qwen2-0.5b", steps=3,
                  batch_size=8, group_size=4, max_new_tokens=6, seq_len=32,
                  overrides=TINY, seed=2),
    ]


def wait_until(cluster, cond, timeout: float = 300.0):
    """Poll a serve-mode condition, failing fast if a client thread died
    (otherwise its error would only surface at serve() exit)."""
    t0 = time.time()
    while not cond():
        if cluster.client_errors:
            job, err = next(iter(cluster.client_errors.items()))
            raise RuntimeError(f"job {job!r} client thread failed: "
                               f"{err!r}") from err
        if time.time() - t0 > timeout:
            raise TimeoutError("serve-mode job made no progress")
        time.sleep(0.05)


def plane(device=None) -> DevicePlane:
    """A device plane over ``device`` (None: the CUDA devices)."""
    return DevicePlane(devices=None if device is None
                       else [torch.device(device)])


def run(interleave: bool, n_groups: int = 1, concurrent: bool = False,
        device=None):
    cluster = PlexCluster(n_groups=n_groups, device_plane=plane(device))
    for g, cfg in enumerate(make_jobs()):
        cluster.add_job(cfg, group_id=g % n_groups)
    t0 = time.time()
    billing = cluster.run(interleave=interleave, concurrent=concurrent)
    wall = time.time() - t0
    return cluster, billing, wall


def part3_serve_mode(device=None):
    """Serve mode: a GRPO job live, a PPO job attached on a new group,
    a third job detached with work queued. Returns the cluster."""
    jobs = make_jobs()
    cluster = PlexCluster(n_groups=1, device_plane=plane(device))
    cluster.add_job(jobs[0], group_id=0)              # GRPO, pre-registered
    t0 = time.time()
    with cluster.serve():
        # wait for the first job to make progress, then attach a PPO job
        # on a NEW group while the plane is live
        wait_until(cluster,
                   lambda: cluster.controllers["alpha"].reward_log)
        cluster.add_job(jobs[1], group_id=1, algo="ppo")
        # and a job that leaves early: detach cancels its queued ops,
        # resolves its in-flight ones, and keeps its bill
        doomed = JobConfig(job_id="gamma", model_name="qwen2-0.5b",
                           steps=50, batch_size=8, group_size=4,
                           max_new_tokens=6, seq_len=32, overrides=TINY,
                           seed=3)
        cluster.add_job(doomed, group_id=0)
        wait_until(cluster,
                   lambda: cluster.controllers["gamma"].steps_completed)
        cluster.remove_job("gamma")
        print("gamma detached after "
              f"{cluster.controllers['gamma'].steps_completed} step(s)")
    print(f"serve wall {time.time() - t0:.1f}s")
    for job in ("alpha", "beta", "gamma"):
        rec = cluster.billing[job]
        print(f"{job}: steps={rec.steps} billed "
              f"gpu_s/step={rec.gpu_seconds_per_step():.2f}")
    return cluster


def part4_auto_placement(device=None):
    """The control plane places three jobs added with ``group_id=None``
    (cold profiling, warm re-fit, a capacity spawn). Returns the
    cluster."""
    cluster = PlexCluster(n_groups=1, device_plane=plane(device))
    t0 = time.time()
    jobs = make_jobs()
    with cluster.serve():
        # group_id=None routes each arrival through the PlacementDirector:
        # cold profiling group -> online JobTrace -> micro-shift warm fit
        # (+ live migration onto the shared group)
        cluster.add_job(jobs[0], group_id=None)
        cluster.add_job(jobs[1], group_id=None)
        wait_until(cluster, lambda: all(
            cluster.director.job_state(j) is not None
            and cluster.director.job_state(j).phase == "warm"
            for j in ("alpha", "beta")))
        # a late arrival finds no clean profiling group: capacity spawn
        late = JobConfig(job_id="delta", model_name="qwen2-0.5b", steps=2,
                         batch_size=8, group_size=4, max_new_tokens=6,
                         seq_len=32, overrides=TINY, seed=4)
        cluster.add_job(late, group_id=None)
    print(f"serve wall {time.time() - t0:.1f}s; control-plane decisions:")
    for e in cluster.director.events:
        print("  ", {k: (round(v, 3) if isinstance(v, float) else v)
                     for k, v in e.items()})
    for job in ("alpha", "beta", "delta"):
        js = cluster.director.job_state(job)
        rec = cluster.billing[job]
        print(f"{job}: phase={js.phase} group={js.group_id} "
              f"steps={rec.steps} billed "
              f"gpu_s/step={rec.gpu_seconds_per_step():.2f}")
    return cluster


def part5_drift_reconciliation(device=None):
    """Scripted VirtualClock demo of the reconciliation loop: jobA's
    rollout doubles mid-run; the phase-drift trigger re-profiles, re-fits,
    and live-migrates it, and the decision log shows every step."""
    clock = VirtualClock()

    class ScriptedWPG:
        """Stub backend on the virtual clock: each op advances time by its
        exec_estimate, so drift is scripted rather than measured."""

        def __init__(self, spec, sm):
            self.spec, self.sm, self.exec_log = spec, sm, []

        @property
        def job_prefix(self):
            return f"{self.spec.job_id}:{self.spec.deployment_id}"

        def resident(self):
            return False

        def ensure_resident(self):
            return 0.0

        def offload(self, to=None):
            return 0.0

        def execute(self, qop):
            clock.advance(qop.exec_estimate)
            self.exec_log.append((qop.op.value, qop.exec_estimate))
            return None

    router = Router(now=clock, wpg_factory=ScriptedWPG,
                    device_plane=plane(device))
    director = PlacementDirector(
        router, DirectorConfig(horizon=300.0, cold_reserve_s=40.0,
                               min_groups=1, warmup_cycles=0,
                               drift_window=2, drift_ratio=1.8),
        initial_groups=[0])
    deps = {}
    for job in ("epsilon", "zeta"):
        gid = director.assign(job)
        spec = api.DeploymentSpec(deployment_id=f"{job}-train", job_id=job,
                                  model_name="stub", role="train")
        deps[job] = router.deploy(spec, group_id=gid)

    def run_cycle(job, phases):
        prev, d = None, deps[job]
        for op, dur in phases:
            fn = getattr(d, op)
            args = ((np.zeros((1, 2), np.int32),) if op == "generate"
                    else (d,) if op == "sync_weights" else (0,))
            prev = fn(*args, exec_estimate=dur,
                      after=(prev,) if prev else ())
        router.drain()
        prev.result()
        director.on_job_step(job)

    for step in range(6):
        rollout = 6.0 if step < 2 else 12.0     # epsilon's rollout DOUBLES
        run_cycle("epsilon", [("generate", rollout),
                              ("update_actor", 2.0 if step < 2 else 3.5)])
        run_cycle("zeta", [("generate", 1.0), ("forward", 2.0),
                           ("update_actor", 2.0), ("sync_weights", 1.0)])
        clock.advance(0.25)
    print("control-plane decision log (virtual time):")
    for e in director.events:
        print("  ", {k: (round(v, 3) if isinstance(v, float) else v)
                     for k, v in e.items()})
    plan = director.cluster_plan()
    for a in plan.assignments:
        print(f"{a.job_id}: group={a.group_id} shift={a.shift:.2f} "
              f"period={a.trace.period:.1f}s (plan v{plan.version})")


def part6_multi_tenant_service(device=None):
    """Two tenants against one live plane: quota-queued admission, an SLO
    tightened mid-serve, and the director's SLO-guarded preemption trigger
    defending the guaranteed tenant — decision log printed. Returns the
    cluster."""
    cluster = PlexCluster(
        n_groups=1,
        # cooldown off: the consolidation migrate would otherwise pin the
        # best-effort job against preemption for 30s of this short demo;
        # the first cycle, with its one-time costs, left out of the
        # profile; a shared group stretches both jobs' cycles, which must
        # not read as phase drift (Part 5's trigger) and re-fit them apart
        director_cfg=DirectorConfig(warmup_cycles=1, max_groups=3,
                                    repack_interval_s=1e9,
                                    migration_cooldown_s=0.0,
                                    drift_ratio=4.0,
                                    slo_window=6, slo_min_samples=3),
        device_plane=plane(device))
    # prod: GUARANTEED with a deliberately loose SLO for now (tightened
    # live below); lab: BEST_EFFORT, low priority, at most ONE job admitted
    cluster.register_tenant(tenancy.TenantSpec(
        "prod", priority=4.0, class_=tenancy.TenantClass.GUARANTEED,
        slo_step_latency_s=1e9))
    cluster.register_tenant(tenancy.TenantSpec(
        "lab", priority=0.5, quota_groups=1))

    def tenant_job(job_id, tenant, steps, seed):
        return JobConfig(job_id=job_id, model_name="qwen2-0.5b",
                         steps=steps, batch_size=8, group_size=4,
                         max_new_tokens=P6_NEW_TOKENS,
                         seq_len=12 + P6_NEW_TOKENS, overrides=TINY,
                         seed=seed, tenant=tenant)

    with cluster.serve():
        cluster.add_job(tenant_job("prod-1", "prod", 10, 1), group_id=None)
        cluster.add_job(tenant_job("lab-1", "lab", 60, 2), group_id=None)
        # the greedy tenant tries to attach a SECOND job: at quota it is
        # a typed denial, and with queue_on_deny it parks instead
        try:
            cluster.add_job(tenant_job("lab-2", "lab", 2, 3), group_id=None)
        except tenancy.AdmissionDenied as denied:
            print(f"lab-2 denied: {denied}")
        cluster.add_job(tenant_job("lab-2", "lab", 2, 3), group_id=None,
                        queue_on_deny=True)
        depth = cluster.router.tenant_telemetry()["lab"]["pending_jobs"]
        print(f"lab-2 admission-queued (lab pending depth: {depth})")
        # wait until prod's rolling p95 is meaningful, then TIGHTEN the
        # SLO below it: the next folded steps breach and trigger 4 fires
        wait_until(cluster, lambda: cluster.tenant_ledger.snapshot()
                   .get("prod", {}).get("step_p95_s") is not None)
        p95 = cluster.tenant_ledger.snapshot()["prod"]["step_p95_s"]
        cluster.register_tenant(tenancy.TenantSpec(
            "prod", priority=4.0, class_=tenancy.TenantClass.GUARANTEED,
            slo_step_latency_s=p95 / 2))
        print(f"prod SLO tightened mid-serve: {p95:.2f}s p95 -> "
              f"{p95 / 2:.2f}s objective")
        wait_until(cluster, lambda: any(
            e["event"] in ("slo_preempt", "slo_hold")
            for e in cluster.director.events))
        # the first lab job leaves: its quota frees and the QUEUED lab-2
        # is admitted automatically by the drain
        cluster.remove_job("lab-1")
        wait_until(cluster, lambda: "lab-2" in cluster.controllers)
        print("lab-1 detached -> queued lab-2 admitted "
              f"(lab active: {cluster.admission.active_count('lab')})")
    print("tenancy decision log:")
    for e in cluster.director.events:
        if e["event"].startswith("slo_") or e["event"] == "spawn_group":
            print("  ", {k: (round(v, 3) if isinstance(v, float) else v)
                         for k, v in e.items()})
    print("per-tenant accounting (Router.tenant_telemetry):")
    for tenant, tel in sorted(cluster.router.tenant_telemetry().items()):
        att = tel.get("slo_attainment")
        print(f"  {tenant}: jobs={tel['jobs']} "
              f"gpu_s={tel.get('gpu_seconds', 0.0):.1f} "
              f"steps={tel.get('steps_total', 0)} "
              f"slo_attainment={att if att is None else round(att, 3)} "
              f"p95={tel.get('step_p95_s')}")
    return cluster


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = ap.parse_args(argv).device
    t_start = time.time()
    print("=== Part 1: one shared group (HRRS multiplexing) ===")
    print("--- isolated (back-to-back) ---")
    c1, b1, w1 = run(interleave=False, device=dev)
    print(f"wall {w1:.1f}s; switches={len(c1.router.switch_log)}")

    print("--- PlexRL multiplexed ---")
    c2, b2, w2 = run(interleave=True, device=dev)
    print(f"wall {w2:.1f}s; switches={len(c2.router.switch_log)}")

    for job in ("alpha", "beta"):
        print(f"{job}: billed gpu_s/step isolated="
              f"{b1[job].gpu_seconds_per_step():.2f} "
              f"multiplexed={b2[job].gpu_seconds_per_step():.2f} "
              f"(switch overhead {b2[job].switch_seconds:.3f}s)")
        r = c2.controllers[job].reward_log
        print(f"{job}: rewards {np.round(r, 3).tolist()}")

    print("\n=== Part 2: two groups (concurrent dispatch plane) ===")
    print("--- serial driver (ops execute inline, no overlap) ---")
    _, _, w3 = run(interleave=True, n_groups=2, concurrent=False,
                   device=dev)
    print(f"wall {w3:.1f}s")

    print("--- concurrent driver (one dispatch thread per group) ---")
    _, _, w4 = run(interleave=True, n_groups=2, concurrent=True,
                   device=dev)
    print(f"wall {w4:.1f}s -> serial/concurrent ratio "
          f"{w3 / max(w4, 1e-9):.2f}x")

    print("\n=== Part 3: serve mode (jobs attach/detach against a live "
          "plane) ===")
    part3_serve_mode(dev)

    print("\n=== Part 4: auto-placement + autoscale (the control "
          "plane) ===")
    part4_auto_placement(dev)

    print("\n=== Part 5: continuous reconciliation (drift -> re-profile -> "
          "repack -> migrate) ===")
    part5_drift_reconciliation(dev)

    print("\n=== Part 6: multi-tenant service layer (quotas, SLO-guarded "
          "preemption) ===")
    part6_multi_tenant_service(dev)

    print("\nNOTE: at these tiny widths every op is a few launches, so"
          "\nneither HRRS (Part 1) nor cross-group overlap (Part 2) can"
          "\nreclaim idle time HERE — both parts are MECHANISM"
          "\ndemonstrations: HRRS-batched context switches, measured setup"
          "\ncosts, per-job billing, and group dispatch on independent"
          "\nworker threads. The capacity gain at cluster scale is what"
          "\nthe simulator quantifies (repro_torch.examples.cluster_sim).")
    print(f"multiplex_rlvr took {time.time() - t_start:.2f} s")


if __name__ == "__main__":
    main()
