"""The port's cluster layer, held against the JAX package on the CPU.

- The jax-free modules the port copies (the scheduler's placement
  machinery, the control plane and tenancy) stay copies of the reference,
  edited only in their import paths.
- The same control-plane flows, written once over a package, replay
  through ``repro`` and ``repro_torch`` under a ``VirtualClock`` with
  duck-typed WPGs that advance the clock by each op's ``exec_estimate``:
  the director's events, the cluster plan, the switch and migrate logs and
  the bills must be equal.
- Two real GRPO jobs run through both packages' ``PlexCluster``: the steps,
  the switch sequence, each WPG's op sequence and the billed steps agree
  (seconds and rewards differ: the inits use each package's own PRNG).
- The Router's control methods, ``StateManager.migrate`` and
  ``launch/train.py`` on torch tensors.
"""
import dataclasses
import importlib
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import tenancy
from repro_torch.core.cluster import PlexCluster
from repro_torch.core.router import Router
from repro_torch.core.state_manager import StateManager, Tier
from repro_torch.launch.mesh import DevicePlane, MeshSlice

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TINY = (("num_layers", 2), ("d_model", 32), ("num_heads", 4),
        ("num_kv_heads", 2), ("head_dim", 8), ("d_ff", 64),
        ("vocab_size", 64), ("tie_embeddings", True))
CPU = torch.device("cpu")
GUARANTEED = tenancy.TenantClass.GUARANTEED

# exact binary fractions: switch seconds sum without rounding
LOAD_S, OFFLOAD_S = 0.25, 0.125


def cpu_plane():
    return DevicePlane(devices=[CPU])


# ------------------------------------------------------- the copies
COPIES = ["core/scheduler/segment_tree.py", "core/scheduler/ring.py",
          "core/scheduler/intervals.py", "core/scheduler/placement.py",
          "core/scheduler/repack_index.py", "core/control_plane/plan.py",
          "core/control_plane/reconcile.py",
          "core/control_plane/director.py",
          "core/control_plane/__init__.py", "core/tenancy/model.py",
          "core/tenancy/accounting.py", "core/tenancy/admission.py",
          "core/tenancy/__init__.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_module_is_a_copy_of_the_reference(rel):
    with open(os.path.join(SRC, "repro", rel)) as f:
        want = f.read().replace("repro.", "repro_torch.")
    with open(os.path.join(SRC, "repro_torch", rel)) as f:
        assert f.read() == want


# ---------------------------------------- one flow, either package
class _Pkg:
    """One package's modules, and its leaves and planes, by name."""

    def __init__(self, name):
        self.name = name
        mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
        self.api = mod("core.api")
        self.tenancy = mod("core.tenancy")
        cp = mod("core.control_plane")
        self.PlacementDirector = cp.PlacementDirector
        self.DirectorConfig = cp.DirectorConfig
        self.JobTrace = mod("core.control_plane.plan").JobTrace
        self.JobConfig = mod("core.controller").JobConfig
        self.Router = mod("core.router").Router
        self.PlexCluster = mod("core.cluster").PlexCluster
        self.VirtualClock = mod("core.scheduler.executor").VirtualClock
        self.torch = name == "repro_torch"

    def plane(self) -> dict:
        return {"device_plane": cpu_plane()} if self.torch else {}

    def router_plane(self) -> dict:
        """A one-device plane for either package's Router: the
        reference's carves ``jax.devices()[:1]``, so its slices (and each
        migration's ``cross_mesh``) do not depend on how many host devices
        an earlier import made jax start with (``repro.launch.dryrun``
        sets 512)."""
        if self.torch:
            return self.plane()
        import jax
        from repro.launch.mesh import DevicePlane
        return {"device_plane": DevicePlane(devices=jax.devices()[:1])}

    def leaf(self, a: np.ndarray):
        return torch.from_numpy(a.copy()) if self.torch else a


PKGS = ("repro", "repro_torch")


class ClockWPG:
    """Deterministic execution backend for either package: advances a
    VirtualClock by each op's ``exec_estimate`` and logs that as its
    seconds; the load half of a switch takes LOAD_S, the offload half
    OFFLOAD_S. A generate returns zero tokens, so the controllers' packing
    and rewards run."""

    def __init__(self, spec, sm, clock):
        self.spec = spec
        self.sm = sm
        self.clock = clock
        self.exec_log = []
        self._resident = False

    @property
    def job_prefix(self):
        return f"{self.spec.job_id}:{self.spec.deployment_id}"

    def resident(self):
        return self._resident

    def ensure_resident(self):
        if self._resident:
            return 0.0
        self._resident = True
        return LOAD_S

    def offload(self, to=None):
        self._resident = False
        return OFFLOAD_S

    def execute(self, qop):
        self.clock.advance(qop.exec_estimate)
        self.exec_log.append((qop.op.value, qop.exec_estimate))
        if qop.op.value == "generate":
            n = len(qop.args[0])
            new = qop.kwargs["max_new_tokens"]
            return {"tokens": np.zeros((n, new), np.int32),
                    "logprobs": np.zeros((n, new), np.float32),
                    "alive": np.ones((n, new), bool)}
        if qop.op.value == "update_actor":
            return {"loss": 0.0}
        return {"req_id": qop.req_id}


def _virtual_router(P):
    clock = P.VirtualClock()
    router = P.Router(now=clock,
                      wpg_factory=lambda spec, sm: ClockWPG(spec, sm, clock),
                      **P.router_plane())
    return clock, router


def _spec(P, job_id):
    return P.api.DeploymentSpec(deployment_id=f"{job_id}-train",
                                job_id=job_id, model_name="stub",
                                role="train")


def _deploy(P, router, job, gid, fill):
    """Deploy ``job`` on ``gid`` with 256 B of managed state."""
    dep = router.deploy(_spec(P, job), group_id=gid)
    wpg = router.wpgs[f"{job}-train"]
    wpg.sm.register(wpg.job_prefix,
                    {"w": P.leaf(np.full((8, 8), fill, np.float32))})
    return dep


def _logs(router, director):
    """What the replays compare: the switch log on the reference's keys,
    the migrate log without its seconds, the plan and the exec logs."""
    keys = ("t", "group", "to_job", "t_offload", "t_load")
    return {
        "switches": [{k: s[k] for k in keys} for s in router.switch_log],
        "migrations": [(m["job"], m["src"], m["dst"], m["bytes"],
                        m["cross_mesh"]) for m in router.migrate_log],
        "plan": dataclasses.asdict(director.cluster_plan()),
        "exec_logs": {d: [tuple(x) for x in router.wpgs[d].exec_log]
                      for d in sorted(router.wpgs)},
    }


def _director_flow(P, n_steps=2):
    """The control-plane flow of tests/test_control_plane.py's replay test
    (cold x2 -> warm consolidation -> migration -> retire -> a third
    arrival's spawn), each job holding managed state."""
    clock, router = _virtual_router(P)
    director = P.PlacementDirector(
        router, P.DirectorConfig(horizon=300.0, cold_reserve_s=40.0,
                                 min_groups=1, warmup_cycles=0),
        initial_groups=[0])
    deps, ordinal = {}, {}

    def submit_cycle(job, rollout, update):
        gen = deps[job].generate(np.zeros((1, 2), np.int32),
                                 max_new_tokens=2, exec_estimate=rollout)
        upd = deps[job].update_actor(0, exec_estimate=update, after=(gen,))
        for f in (gen, upd):
            ordinal[f.sources[0]] = len(ordinal)
        return [gen, upd]

    def add(job):
        gid = director.assign(job)
        deps[job] = _deploy(P, router, job, gid, len(deps) + 1)
        return gid

    g_a, g_b = add("jobA"), add("jobB")
    assert g_a != g_b
    for _ in range(n_steps):
        for job, (r, u) in (("jobA", (6.0, 2.0)), ("jobB", (5.0, 3.0))):
            tails = submit_cycle(job, r, u)
            router.drain()
            for f in tails:
                f.result()
            director.on_job_step(job)
        clock.advance(0.5)
    g_c = add("jobC")
    states = {j: (director.job_state(j).phase, director.job_state(j).group_id)
              for j in ("jobA", "jobB", "jobC")}
    order = [ordinal[t.request.req_id] for t in sorted(
        router.executor.tasks.values(), key=lambda t: t.t_started)
        if t.request.req_id in ordinal]
    return dict(events=[dict(e) for e in director.events], states=states,
                order=order, g_c=g_c, **_logs(router, director))


def test_director_flow_replays_identically_across_packages():
    ref, port = (_director_flow(_Pkg(n)) for n in PKGS)
    kinds = [e["event"] for e in port["events"]]
    assert kinds.count("migrate") == 1 and "retire_group" in kinds \
        and "spawn_group" in kinds
    # the consolidation moved one job's 256 B on the one device
    assert [m[3:] for m in port["migrations"]] == [(256, False)]
    assert port["switches"]
    for key in ref:
        assert port[key] == ref[key], key


def _slo_flow(P):
    """The two-tenant SLO flow of tests/test_tenancy.py's replay test: a
    GUARANTEED tenant's breach preempts the BEST_EFFORT job onto a spawned
    group."""
    clock, router = _virtual_router(P)
    ten = P.tenancy
    reg = ten.TenantRegistry()
    reg.register(ten.TenantSpec("gold", priority=4.0,
                                class_=ten.TenantClass.GUARANTEED,
                                slo_step_latency_s=4.0))
    reg.register(ten.TenantSpec("scav", priority=1.0))
    ledger = ten.TenantLedger(reg, slo_window=4, slo_min_samples=2)
    director = P.PlacementDirector(
        router,
        P.DirectorConfig(horizon=300.0, warmup_cycles=0, max_groups=2,
                         drift_ratio=100.0, repack_interval_s=1e9,
                         spawn_queue_depth=999, slo_window=4,
                         slo_min_samples=2, slo_hold_s=1e9),
        initial_groups=[0], tenancy=ledger)
    for job, tenant, prio in (("gA", "gold", 4.0), ("bE", "scav", 1.0)):
        ledger.bind_job(job, tenant)
        router.register_job_tenant(job, tenant, priority=prio)
    director.adopt_warm("gA", P.JobTrace(3.0, ((2.0, 1.0),)), 0)
    director.adopt_warm("bE", P.JobTrace(9.0, ((8.0, 1.0),)), 0)
    deps = {job: _deploy(P, router, job, 0, i + 1)
            for i, job in enumerate(("gA", "bE"))}
    prompt = np.zeros((1, 2), np.int32)
    futs = []
    for _ in range(4):
        futs.append(deps["gA"].generate(prompt, max_new_tokens=2,
                                        exec_estimate=2.0))
        bg = deps["bE"].generate(prompt, max_new_tokens=2, exec_estimate=8.0)
        futs += [bg, deps["bE"].update_actor(0, exec_estimate=1.0,
                                             after=(bg,))]
        router.drain()
        futs.append(deps["gA"].update_actor(0, exec_estimate=1.0))
        router.drain()
        director.on_job_step("gA")
        director.on_job_step("bE")
        clock.advance(0.25)
    router.drain()
    for f in futs:
        f.result()
    states = {j: (director.job_state(j).phase, director.job_state(j).group_id)
              for j in ("gA", "bE")}
    return dict(events=[dict(e) for e in director.events],
                ledger=ledger.snapshot(), states=states,
                **_logs(router, director))


def test_slo_two_tenant_flow_replays_identically_across_packages():
    ref, port = (_slo_flow(_Pkg(n)) for n in PKGS)
    kinds = [e["event"] for e in port["events"]]
    assert "slo_breach" in kinds and "slo_preempt" in kinds
    assert [m[0] for m in port["migrations"]] == ["bE"]
    for key in ref:
        assert port[key] == ref[key], key


def _quota_flow(P):
    """A group quota denies, queues and drains on ``remove_job``; every
    admitted job then runs one step and is billed."""
    clock = P.VirtualClock()
    c = P.PlexCluster(
        n_groups=1, wpg_factory=lambda spec, sm: ClockWPG(spec, sm, clock),
        **P.plane())
    ten = P.tenancy
    c.register_tenant(ten.TenantSpec("acme", priority=2.0, quota_groups=1))

    def cfg(job_id):
        return P.JobConfig(job_id=job_id, model_name="stub", steps=1,
                           batch_size=4, group_size=2, prompt_len=8,
                           max_new_tokens=4, seq_len=16, tenant="acme")

    out = {}
    c.add_job(cfg("a1"))
    with pytest.raises(ten.AdmissionDenied) as ei:
        c.add_job(cfg("a2"))
    out["denied"] = (ei.value.tenant_id, ei.value.job_id, ei.value.reason)
    out["queued"] = c.add_job(cfg("a3"), queue_on_deny=True) is None
    out["pending"] = c.admission.pending_depth("acme")
    c.run()
    c.remove_job("a1")
    out["drained"] = sorted(c.controllers)
    out["after"] = (c.admission.pending_depth("acme"),
                    c.admission.active_count("acme"),
                    c.tenant_ledger.tenant_of("a3"),
                    c.router.job_priority["a3"])
    c.run()
    out["bills"] = {j: dataclasses.asdict(r) for j, r in c.billing.items()}
    out["gpu_seconds"] = c.tenant_ledger.gpu_seconds("acme")
    out["telemetry"] = c.router.tenant_telemetry()
    out["switches"] = [(s["group"], s["to_job"], s["t_offload"], s["t_load"])
                       for s in c.router.switch_log]
    return out


def test_group_quota_flow_replays_identically_across_packages():
    ref, port = (_quota_flow(_Pkg(n)) for n in PKGS)
    assert port["denied"] == ("acme", "a2", tenancy.REASON_GROUP_QUOTA)
    assert port["queued"] and port["pending"] == 1
    assert port["drained"] == ["a1", "a3"]
    # init 1.0 + generate 1.0 + update 1.0 each, and a load apiece
    assert port["bills"]["a3"] == dict(job_id="a3", busy_seconds=3.0,
                                       switch_seconds=LOAD_S, steps=1)
    for key in ref:
        assert port[key] == ref[key], key


# ------------------------------------- real GRPO jobs, both clusters
def _tiny(P, job_id, seed, steps=2, tenant="default"):
    return P.JobConfig(job_id=job_id, model_name="qwen2-0.5b", steps=steps,
                       batch_size=4, group_size=2, max_new_tokens=4,
                       seq_len=24, overrides=TINY, seed=seed, tenant=tenant)


def _two_grpo_jobs(P):
    c = P.PlexCluster(n_groups=1, **P.plane())
    c.add_job(_tiny(P, "jobA", 1))
    c.add_job(_tiny(P, "jobB", 2))
    billing = c.run(interleave=True)
    return c, billing


def test_two_grpo_jobs_agree_with_the_reference_cluster():
    runs = {n: _two_grpo_jobs(_Pkg(n)) for n in PKGS}
    seen = {}
    for name, (c, billing) in runs.items():
        for rec in billing.values():
            assert rec.busy_seconds > 0 and rec.switch_seconds > 0, name
        seen[name] = dict(
            steps={j: (c.controllers[j].steps_completed,
                       len(c.controllers[j].metrics_log),
                       billing[j].steps) for j in billing},
            to_job=[s["to_job"] for s in c.router.switch_log],
            ops={d: [op for op, _ in w.exec_log]
                 for d, w in sorted(c.router.wpgs.items())})
    assert seen["repro_torch"]["steps"] == {"jobA": (2, 2, 2),
                                            "jobB": (2, 2, 2)}
    assert seen["repro_torch"] == seen["repro"]
    c, billing = runs["repro_torch"]
    for job, rec in billing.items():
        logged = sum(dt for w in c.router.wpgs.values()
                     if w.spec.job_id == job for _, dt in w.exec_log)
        assert rec.busy_seconds == pytest.approx(logged)
        assert all(np.isfinite(m["loss"])
                   for m in c.controllers[job].metrics_log)


# --------------------------------- the Router's control methods
def test_reassign_job_migrates_state_and_queued_ops():
    P = _Pkg("repro_torch")
    clock, router = _virtual_router(P)
    dep = _deploy(P, router, "jobA", 0, 1.0)
    sm0 = router.state_managers[0]
    wpg = router.wpgs["jobA-train"]
    ref = sm0.entries[f"{wpg.job_prefix}/params/w"].ref
    done = [dep.forward(i, exec_estimate=1.0) for i in range(2)]
    router.drain()
    queued = [dep.forward(i, exec_estimate=1.0) for i in range(3)]
    assert router.reassign_job("jobA", 3) == 256
    assert router.group_of["jobA-train"] == 3 and wpg.sm is \
        router.state_managers[3]
    assert not sm0.keys_for(wpg.job_prefix)
    # the same device: the tensor changed owner without a copy
    assert router.state_managers[3].entries[
        f"{wpg.job_prefix}/params/w"].ref is ref
    assert router.executor.queued_count.get(0, 0) == 0
    router.drain()
    for f in done + queued:
        assert f.result()["req_id"] > 0
    assert len(wpg.exec_log) == 5       # billing's source survived
    # migrated after the first two ops, in no virtual time
    assert router.migrate_log == [dict(
        job="jobA", src=0, dst=3, bytes=256, seconds=0.0, cross_mesh=False,
        t=2.0)]


class SleepWPG(ClockWPG):
    """Executes in wall-clock time (no virtual clock)."""

    def __init__(self, spec, sm):
        super().__init__(spec, sm, None)

    def execute(self, qop):
        self.exec_log.append((qop.op.value, 0.0))
        return {"req_id": qop.req_id}


def _serve_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("serve-") and t.is_alive()]


def test_retire_group_tears_down_worker_and_state():
    router = Router(wpg_factory=SleepWPG, device_plane=cpu_plane())
    P = _Pkg("repro_torch")
    dep0 = router.deploy(_spec(P, "j0"), group_id=0)
    dep5 = router.deploy(_spec(P, "j5"), group_id=5)
    assert router.device_plane.slice_index(5) == 0
    with router:
        assert len(_serve_threads()) == 2
        with pytest.raises(RuntimeError, match="still hosts"):
            router.retire_group(5)
        assert dep5.forward(0).wait(timeout=10.0)["req_id"] > 0
        router.teardown("j5-train")
        with pytest.raises(RuntimeError, match="never created, or torn down"):
            dep5.forward(0)
        router.retire_group(5)
        assert len(_serve_threads()) == 1
        assert 5 not in router.executor.locks
        assert 5 not in router.state_managers
        assert router.device_plane.slice_index(5) is None  # lease returned
        assert dep0.forward(0).wait(timeout=10.0)["req_id"] > 0
        router.ensure_group(5)           # leases slice 0 again, spawns
        assert len(_serve_threads()) == 2
        assert router.mesh_domains() == {0: 0, 5: 0}
    assert not _serve_threads()
    assert router.abandoned_workers() == []


def test_group_telemetry_reports_depth_and_occupancy():
    P = _Pkg("repro_torch")
    clock, router = _virtual_router(P)
    dep = router.deploy(_spec(P, "jobA"), group_id=0)
    router.ensure_group(2)
    for i in range(4):
        dep.forward(i, exec_estimate=1.0)
    t = router.group_telemetry()
    assert t[0]["queue_depth"] == 4
    assert t[0]["deployments"] == ["jobA-train"]
    assert t[2]["queue_depth"] == 0 and not t[2]["deployments"]
    router.drain()
    t = router.group_telemetry()
    assert t[0]["queue_depth"] == 0
    assert t[0]["busy_seconds"] == pytest.approx(4.0)


def test_teardown_of_running_best_effort_bills_and_spares_guaranteed():
    """Detaching a BEST_EFFORT job while it has work in flight bills what
    it ran to its tenant, frees its managed state and leaves the
    GUARANTEED job's futures unpoisoned (tests/test_tenancy.py's case, on
    the port's tiny models)."""
    P = _Pkg("repro_torch")
    c = PlexCluster(n_groups=1, device_plane=cpu_plane())
    c.register_tenant(tenancy.TenantSpec("gold", priority=4.0,
                                         class_=GUARANTEED))
    c.register_tenant(tenancy.TenantSpec("scav", priority=1.0))
    c.add_job(_tiny(P, "g-job", seed=1, steps=2, tenant="gold"))
    sm = c.router.state_managers[0]
    with c.serve():
        deadline = time.monotonic() + 120
        while not c.controllers["g-job"].reward_log:
            assert time.monotonic() < deadline, "gold job made no progress"
            time.sleep(0.01)
        c.add_job(_tiny(P, "b-job", seed=2, steps=50, tenant="scav"))
        while c.controllers["b-job"].steps_completed < 1:
            assert time.monotonic() < deadline, "be job made no progress"
            time.sleep(0.01)
        assert sm.job_bytes("b-job:b-job-train") > 0
        c.remove_job("b-job")
        assert sm.job_bytes("b-job:b-job-train") == 0
    gold = c.controllers["g-job"]
    assert gold.steps_completed == 2
    assert all(np.isfinite(m["loss"]) for m in gold.metrics_log)
    assert c.billing["b-job"].busy_seconds > 0.0
    assert c.tenant_ledger.gpu_seconds("scav") > 0.0
    for tenant, job in (("gold", "g-job"), ("scav", "b-job")):
        rec = c.billing[job]
        assert c.tenant_ledger.gpu_seconds(tenant) == pytest.approx(
            rec.busy_seconds + rec.switch_seconds)
    assert c.admission.active_count("scav") == 0
    assert c.tenant_ledger.tenant_of("b-job") == "default"


def test_unported_pieces_raise_naming_their_roadmap_item():
    """The production meshes, ported, are built on ``meta``;
    ``mesh_bench.py`` is the one part left in ``PARTS``; a process-mode
    group of several devices, ported, spawns its child on its slice; a PPO
    job (an actor and a critic deployment) attaches."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import sharding as shd

    P = _Pkg("repro_torch")
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16}
    assert {d.type for d in m.flat_devices()} == {"meta"}
    assert set(shd.PARTS) == {6} and "mesh_bench.py" in shd.PARTS[6]
    pc = PlexCluster(device_plane=DevicePlane(devices=[CPU] * 2),
                     devices_per_group=2, process_plane=True)
    try:
        gp = pc.router.group_procs[0]
        assert (gp.devices, gp.device_ids) == (["cpu", "cpu"], [0, 1])
    finally:
        pc.router.close_processes()
    c = PlexCluster(device_plane=cpu_plane(), wpg_factory=SleepWPG)
    ctl = c.add_job(_tiny(P, "p", 1), algo="ppo")
    assert type(ctl).__name__ == "RLControllerPPO"
    assert {s.role for s in c.router.deployments.values()} == {"train",
                                                               "critic"}
    assert c.admission.active_count("default") == 1


# ---------------------------------------------- StateManager.migrate
def _sm_pair(dst_device=CPU):
    return (StateManager("g0", mesh_slice=MeshSlice(0, CPU)),
            StateManager("g1", mesh_slice=MeshSlice(1, torch.device(
                dst_device))))


def _state(sm):
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(8, 16, generator=gen).to(torch.bfloat16),
            "b": torch.randn(16, generator=gen)}
    sm.register("job:dep", tree, Tier.DEVICE, "params")
    sm.register("job:dep", {"mu": {k: torch.zeros_like(v)
                                   for k, v in tree.items()}},
                Tier.DEVICE, "opt")
    return {k: e.ref.clone() for k, e in sm.entries.items()}


def test_migrate_hands_over_entries_bit_exact_keeping_tiers():
    src, dst = _sm_pair()
    before = _state(src)
    src.offload(["job:dep/params/b"])
    pinned = torch.empty(16)             # stands in for the pinned buffer
    src.entries["job:dep/params/b"].host = pinned
    refs = {k: e.ref for k, e in src.entries.items()}
    moved = src.migrate("job:dep", dst)
    assert moved == sum(v.numel() * v.element_size() for v in before.values())
    assert not src.keys_for("job:dep") and not src.entries
    assert src.last_migrate == dict(bytes=moved,
                                    seconds=src.last_migrate["seconds"],
                                    cross_mesh=False, keys=len(before))
    assert src.bytes_moved["migrate"] == moved
    for k, v in before.items():
        e = dst.entries[k]
        assert e.ref is refs[k] and torch.equal(e.ref, v)
        assert e.tier == (Tier.HOST if k == "job:dep/params/b"
                          else Tier.DEVICE)
    assert dst.entries["job:dep/params/b"].host is pinned


def test_migrate_across_devices_copies_device_entries():
    src, dst = _sm_pair("meta")
    before = _state(src)
    src.offload(["job:dep/params/b"])
    src.migrate("job:dep", dst)
    assert src.last_migrate["cross_mesh"] is True
    for k, v in before.items():
        e = dst.entries[k]
        want = "cpu" if e.tier == Tier.HOST else "meta"
        assert e.ref.device.type == want and e.ref.shape == v.shape


def test_mid_migration_failure_rolls_back():
    src, dst = _sm_pair()
    before = _state(src)

    class FailingEntries(dict):
        inserts = 0

        def __setitem__(self, k, v):
            type(self).inserts += 1
            if type(self).inserts == 2:
                raise RuntimeError("injected mid-migration failure")
            super().__setitem__(k, v)

    dst.entries = FailingEntries()
    with pytest.raises(RuntimeError, match="injected"):
        src.migrate("job:dep", dst)
    assert set(src.keys_for("job:dep")) == set(before)
    for k, v in before.items():
        assert torch.equal(src.entries[k].ref, v)
    assert not dst.entries and src.last_migrate is None


# ------------------------------------------------ the entry point
def test_train_entry_point_runs_without_jax_or_reference_package():
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        "import torch",
        "torch.set_num_threads(1)",
        "from repro_torch.launch import train",
        "train.main(['--device', 'cpu', '--jobs', '2', '--steps', '1',",
        "            '--layers', '2', '--d-model', '64', '--vocab', '128',",
        "            '--batch-size', '4', '--group-size', '2',",
        "            '--max-new-tokens', '4', '--seq-len', '16'])",
    ])
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for job in ("job0", "job1"):
        assert f"[{job}] steps=1" in proc.stdout, proc.stdout
        assert f"[{job}] loss first=" in proc.stdout, proc.stdout
    assert "device=cpu" in proc.stdout
