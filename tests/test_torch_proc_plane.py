"""The port's process plane (repro_torch/launch/proc_plane.py) with stub
children, held against tests/test_proc_plane.py.

Each test of the reference's file that needs no model, on the port: spawn
and ready handshake, execute round trips with the parent's ExecLog mirror,
an op's error against a child's death (dependents poisoned either way),
the heartbeat, serve-mode attach, a crash respawned by the director's
capacity adjuster with billing conserved, the StateManager's export/import
halves (inline and spilled), the shm reply and the cross-child sync relay,
a child dying mid-sync and the sweep of orphaned spill files. The stub
children (``repro_torch.launch.stub_wpg``, by name) never import torch.

The reference's wall-clock overlap ratio fails under load (xdist), so the
overlap test asserts instead that two children's busy intervals on the
system-wide monotonic clock intersect. The real-model children are in
tests/test_torch_proc_real.py.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core.cluster import PlexCluster as RefCluster
from repro_torch.core import api
from repro_torch.core.cluster import BillingRecord, PlexCluster
from repro_torch.core.router import Router
from repro_torch.core.state_manager import StateManager, Tier
from repro_torch.launch import shm_transport as shmt
from repro_torch.launch.mesh import DevicePlane
from repro_torch.launch.proc_plane import (GroupProcess, GroupProcessError,
                                           _ChildState)

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STUB = "repro_torch.launch.stub_wpg:make_busy_wpg"
CRASH_STORE = "repro_torch.launch.stub_wpg:make_crash_store_wpg"

needs_shm = pytest.mark.skipif(
    not shmt.shm_available(), reason="no usable shared memory on this host")


@pytest.fixture(autouse=True)
def private_tmp(tmp_path, monkeypatch):
    """Spill directories (``<tmp>/plexrl_<node>``, here and in the
    children) under this test's own directory: other test processes use
    the same node ids."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def cpu_plane():
    return DevicePlane(devices=[torch.device("cpu")])


def proc_router(**kw):
    return Router(process_plane=True, device_plane=cpu_plane(), **kw)


def my_shm_segments():
    """Live /dev/shm segments of THIS parent process's plane."""
    prefix = f"pxl{os.getpid()}g"
    try:
        return sorted(n for n in os.listdir(shmt.SHM_DIR)
                      if n.startswith(prefix))
    except FileNotFoundError:
        return []


def make_proc_router(n_groups=2, factory=STUB):
    r = proc_router(proc_wpg_factory=factory)
    specs = []
    for g in range(n_groups):
        spec = api.DeploymentSpec(deployment_id=f"dep{g}", job_id=f"job{g}",
                                  model_name="stub", role="train")
        r.create_deployment(spec, group_id=g)
        specs.append(spec)
    return r, specs


def test_proc_plane_modules_import_only_the_stdlib():
    """A spawned child imports proc_plane (and through it shm_transport)
    before it applies its device environment, and a stub child runs
    stub_wpg: none of the three may load torch or numpy at import."""
    code = "\n".join([
        "import sys",
        "for m in ('torch', 'numpy', 'jax', 'repro'):",
        "    sys.modules[m] = None",
        "import repro_torch.launch.proc_plane",
        "import repro_torch.launch.shm_transport",
        "import repro_torch.launch.stub_wpg",
        "print('ok')"])
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


# ------------------------------------------------------------ dispatch
def test_execute_roundtrip_and_log_mirror():
    r, specs = make_proc_router(n_groups=2)
    try:
        futs = [r.submit_queued_operation(
            api.make_op(s, api.Op.FORWARD, 0)) for s in specs]
        assert r.run_until_idle(timeout=120) == 2
        pids = {f.result()["pid"] for f in futs}
        assert len(pids) == 2 and os.getpid() not in pids
        for s in specs:
            log = list(r.wpgs[s.deployment_id].exec_log)
            assert len(log) == 1 and log[0][0] == "forward"
        assert not r.pending
    finally:
        r.close_processes()


def test_remote_error_poisons_dependents_child_survives():
    r, specs = make_proc_router(n_groups=1)
    try:
        bad = api.make_op(specs[0], api.Op.FORWARD, 0, fail=True)
        dep = api.make_op(specs[0], api.Op.FORWARD, 1,
                          prerequisites=(bad.req_id,))
        f_bad = r.submit_queued_operation(bad)
        f_dep = r.submit_queued_operation(dep)
        r.run_until_idle(timeout=120)
        with pytest.raises(RuntimeError, match="asked to fail"):
            f_bad.result()
        with pytest.raises(RuntimeError, match="prerequisite"):
            f_dep.result()
        assert r.process_health() == {0: True}
        f_ok = r.submit_queued_operation(
            api.make_op(specs[0], api.Op.FORWARD, 2))
        r.run_until_idle(timeout=120)
        assert f_ok.result()["op"] == "forward"
    finally:
        r.close_processes()


def test_heartbeat_and_health():
    r, _ = make_proc_router(n_groups=1)
    try:
        rtt = r.group_procs[0].ping(timeout=30.0)
        assert rtt is not None and 0.0 <= rtt < 30.0
        assert r.process_health() == {0: True}
        assert r.group_telemetry()[0]["process_alive"] is True
    finally:
        r.close_processes()
    assert r.process_health() == {}


def test_serve_mode_attach():
    r, specs = make_proc_router(n_groups=1)
    try:
        with r:
            f = r.submit_queued_operation(
                api.make_op(specs[0], api.Op.FORWARD, 0))
            assert f.wait(timeout=120)
            assert f.result()["op"] == "forward"
            spec2 = api.DeploymentSpec(deployment_id="dep9", job_id="job9",
                                       model_name="stub", role="train")
            r.create_deployment(spec2, group_id=5)
            f2 = r.submit_queued_operation(
                api.make_op(spec2, api.Op.FORWARD, 0))
            assert f2.wait(timeout=120)
        assert set(r.process_health()) == {0, 5}
    finally:
        r.close_processes()


def test_group_process_runs_on_the_card_unless_asked_for_the_cpu():
    """A GroupProcess built without a device runs its child on ``cuda:0``:
    a child that then sees no card raises instead of carrying on on the
    CPU. Only an explicit ``devices=["cpu"]`` (the tests' DevicePlane)
    gets the CPU."""
    gp = GroupProcess(0, start=False)
    assert gp.device == "cuda:0"
    cfg = {"group_id": 0, "node_id": "g0", "slice_index": 0,
           "devices": [gp.device], "device_ids": [0]}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="sees no CUDA device"):
            _ChildState(cfg)._state_manager(needs_real=True)
    sm = _ChildState(dict(cfg, devices=["cpu"]))._state_manager(
        needs_real=True)
    assert isinstance(sm, StateManager)
    assert sm.mesh_slice.device == torch.device("cpu")
    r = proc_router(proc_wpg_factory=STUB)
    try:
        r.create_deployment(api.DeploymentSpec(
            deployment_id="d", job_id="j", model_name="stub", role="train"))
        assert r.group_procs[0].device == "cpu"
    finally:
        r.close_processes()


# --------------------------------------------- robustness: crash mid-op
def test_worker_process_crash_respawn_and_billing_conserved():
    """A child dying mid-op fails the RUNNING op, poisons its dependents,
    is respawned by the capacity adjuster on the next director poll, and
    the ops completed before the crash stay billed (the ExecLog mirror
    lives in the parent)."""
    c = PlexCluster(n_groups=1, process_plane=True, proc_wpg_factory=STUB,
                    device_plane=cpu_plane())
    r = c.router
    spec = api.DeploymentSpec(deployment_id="dep0", job_id="job0",
                              model_name="stub", role="train")
    r.create_deployment(spec, group_id=0)
    c.billing["job0"] = BillingRecord(job_id="job0")
    try:
        ok = r.submit_queued_operation(
            api.make_op(spec, api.Op.FORWARD, 0, sleep_s=0.01))
        bad = api.make_op(spec, api.Op.FORWARD, 1, crash=True)
        f_bad = r.submit_queued_operation(bad)
        f_dep = r.submit_queued_operation(
            api.make_op(spec, api.Op.FORWARD, 2,
                        prerequisites=(bad.req_id,)))
        r.run_until_idle(timeout=120)
        assert ok.result()["seconds"] >= 0.01
        with pytest.raises(RuntimeError,
                           match="group 0 worker process died"):
            f_bad.result()
        with pytest.raises(RuntimeError, match="prerequisite"):
            f_dep.result()
        assert r.process_health() == {0: False}
        c._bill_from_logs()
        assert c.billing["job0"].busy_seconds >= 0.01
        billed_before = c.billing["job0"].busy_seconds
        c.director.poll()
        assert [e for e in c.director.events
                if e["event"] == "respawn_group" and e["group"] == 0]
        assert r.process_health() == {0: True}
        f2 = r.submit_queued_operation(
            api.make_op(spec, api.Op.FORWARD, 3, sleep_s=0.01))
        r.run_until_idle(timeout=120)
        assert f2.result()["op"] == "forward"
        c._bill_from_logs()
        assert c.billing["job0"].busy_seconds > billed_before
    finally:
        r.close_processes()


# -------------------------------------------------- migration transport
def test_export_import_roundtrip_with_disk_spill(tmp_path):
    """The migrate-export/import halves in isolation (no processes): host
    staging, bf16 as a 16-bit view, the spill tier above max_inline_bytes
    (spill files consumed on import), and a rollback."""
    src = StateManager(node_id="src", disk_dir=str(tmp_path / "src"))
    dst = StateManager(node_id="dst", disk_dir=str(tmp_path / "dst"))
    big = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    small = torch.ones(8).to(torch.bfloat16)
    src.register("jobA:dep0", {"w": big, "b": small}, Tier.HOST)
    payload = src.export_state("jobA:dep0", max_inline_bytes=1024)
    spilled = [e for e in payload["entries"] if e["path"] is not None]
    inline = [e for e in payload["entries"] if e["data"] is not None]
    assert len(spilled) == 1 and len(inline) == 1
    assert inline[0]["is_bf16"] and inline[0]["data"].dtype == np.uint16
    assert os.path.exists(spilled[0]["path"])
    moved = dst.import_state(payload)
    assert moved == payload["bytes"] == 4096 * 4 + 8 * 2
    got = dst.gather("jobA:dep0", {"w": None, "b": None})
    assert torch.equal(got["w"], big)
    assert got["b"].dtype == torch.bfloat16 and torch.equal(got["b"], small)
    assert not os.path.exists(spilled[0]["path"])
    assert dst.last_migrate["keys"] == 2
    bad = {"entries": [
        {"key": "jobB:dep0/params/x", "nbytes": 8, "version": 0,
         "tier": int(Tier.HOST), "is_bf16": False, "spec": None,
         "path": None, "data": np.ones(2, np.float32)},
        {"key": "jobB:dep0/params/y", "nbytes": 8, "version": 0,
         "tier": int(Tier.HOST), "is_bf16": False, "spec": None,
         "path": str(tmp_path / "missing.npy"), "data": None}]}
    with pytest.raises(FileNotFoundError):
        dst.import_state(bad)
    assert dst.keys_for("jobB:dep0") == []


def test_process_plane_groups_run_at_once():
    """Two groups' compute-bound ops (a GIL-holding spin in each child)
    run at the same time: their busy intervals on the system-wide
    monotonic clock intersect."""
    r, specs = make_proc_router(n_groups=2)
    try:
        for s in specs:         # warm: spawn and handshake first
            r.submit_queued_operation(api.make_op(s, api.Op.FORWARD, 0))
        r.run_until_idle(timeout=120)
        futs = [r.submit_queued_operation(
            api.make_op(s, api.Op.FORWARD, 1, busy_s=0.5, span=True))
            for s in specs]
        r.run_until_idle(timeout=120)
        (a0, a1), (b0, b1) = (tuple(f.result()["span"]) for f in futs)
        assert a1 - a0 >= 0.5 and b1 - b0 >= 0.5
        assert max(a0, b0) < min(a1, b1), ((a0, a1), (b0, b1))
    finally:
        r.close_processes()


# ------------------------------------------------- shared-memory transport
@needs_shm
def test_shm_execute_reply_roundtrip_and_no_residue():
    """A large result rides shm descriptors, not the pipe: bit-identical,
    an owning tensor, one pooled segment across repeats, and a closed
    plane leaves /dev/shm clean."""
    r, specs = make_proc_router(n_groups=1)
    try:
        futs = [r.submit_queued_operation(
            api.make_op(specs[0], api.Op.FORWARD, i, payload_mb=4))
            for i in range(3)]
        r.run_until_idle(timeout=120)
        want = torch.arange((4 << 20) // 8, dtype=torch.float64)
        for f in futs:
            got = f.result()["data"]
            assert isinstance(got, torch.Tensor)
            assert got.untyped_storage().resizable()   # owning, not a view
            assert torch.equal(got, want)
        assert len(r.group_procs[0]._seen_child_segs) == 1
    finally:
        r.close_processes()
    assert my_shm_segments() == []


def test_pickle_route_when_shm_is_off():
    """``shm_transport=False`` picks the pickle path up front: the same
    result, bit-identical, and no segment created on either side."""
    r = proc_router(proc_wpg_factory=STUB, shm_transport=False)
    spec = api.DeploymentSpec(deployment_id="dep0", job_id="job0",
                              model_name="stub", role="train")
    try:
        r.create_deployment(spec, group_id=0)
        assert not r.group_procs[0].shm_enabled
        f = r.submit_queued_operation(
            api.make_op(spec, api.Op.FORWARD, 0, payload_mb=2))
        r.run_until_idle(timeout=120)
        got = f.result()["data"]
        assert np.array_equal(np.asarray(got),
                              np.arange((2 << 20) // 8, dtype=np.float64))
        assert r.group_procs[0]._seen_child_segs == set()
        assert my_shm_segments() == []
    finally:
        r.close_processes()


@needs_shm
def test_shm_cross_child_sync_checksum():
    """A cross-child sync_weights as a descriptor relay: the target child
    copies the source child's segment views and the landed parameters
    checksum exactly."""
    mb = 4
    r = proc_router(proc_wpg_factory=STUB)
    src = api.DeploymentSpec(deployment_id="src0", job_id="jobS",
                             model_name="stub", role="train",
                             overrides=(("sync_mb", mb),))
    dst = api.DeploymentSpec(deployment_id="dst0", job_id="jobS",
                             model_name="stub", role="rollout")
    try:
        r.create_deployment(src, group_id=0)
        r.create_deployment(dst, group_id=1)
        d_src, d_dst = api.Deployment(src, r), api.Deployment(dst, r)
        f_sync = d_src.sync_weights(d_dst)
        r.run_until_idle(timeout=120)
        f_sync.result()
        f_sum = r.submit_queued_operation(
            api.make_op(dst, api.Op.FORWARD, 0, stored_sum=True))
        r.run_until_idle(timeout=120)
        n = (mb << 20) // 4
        assert f_sum.result()["stored_sum"] == float(n * (n - 1) // 2)
    finally:
        r.close_processes()
    assert my_shm_segments() == []


@needs_shm
def test_child_crash_mid_sync_with_shm_in_flight():
    """The TARGET child dies inside its store while the source child's
    descriptors are in flight: the sync fails, its dependents poison, the
    source keeps serving, the completed op's bill survives and the respawn
    leaves no /dev/shm residue of the dead incarnation."""
    r = proc_router(proc_wpg_factory=CRASH_STORE)
    src = api.DeploymentSpec(deployment_id="src0", job_id="jobS",
                             model_name="stub", role="train",
                             overrides=(("sync_mb", 4),))
    dst = api.DeploymentSpec(deployment_id="dst0", job_id="jobS",
                             model_name="stub", role="rollout")
    try:
        r.create_deployment(src, group_id=0)
        r.create_deployment(dst, group_id=1)
        f_pre = r.submit_queued_operation(
            api.make_op(dst, api.Op.FORWARD, 0, sleep_s=0.01))
        r.run_until_idle(timeout=120)
        assert f_pre.result()["seconds"] >= 0.01
        pre_log = list(r.wpgs["dst0"].exec_log)
        d_src, d_dst = api.Deployment(src, r), api.Deployment(dst, r)
        f_sync = d_src.sync_weights(d_dst)
        f_dep = r.submit_queued_operation(
            api.make_op(dst, api.Op.FORWARD, 1, prerequisites=(f_sync,)))
        r.run_until_idle(timeout=120)
        with pytest.raises((RuntimeError, GroupProcessError),
                           match="worker process died"):
            f_sync.result()
        with pytest.raises(RuntimeError, match="prerequisite"):
            f_dep.result()
        assert r.process_health() == {0: True, 1: False}
        assert list(r.wpgs["dst0"].exec_log) == pre_log
        f_ok = r.submit_queued_operation(api.make_op(src, api.Op.FORWARD, 2))
        r.run_until_idle(timeout=120)
        assert f_ok.result()["op"] == "forward"
        dead_prefix = f"pxl{os.getpid()}g1s1"
        assert r.respawn_dead_groups() == [1]
        assert not [n for n in my_shm_segments()
                    if n.startswith(dead_prefix)]
        f2 = r.submit_queued_operation(api.make_op(dst, api.Op.FORWARD, 3))
        r.run_until_idle(timeout=120)
        assert f2.result()["op"] == "forward"
    finally:
        r.close_processes()
    assert my_shm_segments() == []


def test_respawn_sweeps_orphaned_spill_files():
    """A crash between export and import orphans the transfer's spill
    files; the respawn's sweep removes them, and only them."""
    r, specs = make_proc_router(n_groups=1)
    spill_dir = r.group_procs[0].spill_dir()
    os.makedirs(spill_dir, exist_ok=True)
    orphan = os.path.join(spill_dir, "export__deadbeef__jobX__w.npy")
    keeper = os.path.join(spill_dir, "jobX__w.npy")
    try:
        for p in (orphan, keeper):
            with open(p, "wb") as fh:
                fh.write(b"\x93NUMPY")
        f_bad = r.submit_queued_operation(
            api.make_op(specs[0], api.Op.FORWARD, 0, crash=True))
        r.run_until_idle(timeout=120)
        with pytest.raises(RuntimeError, match="worker process died"):
            f_bad.result()
        assert r.respawn_dead_groups() == [0]
        assert not os.path.exists(orphan)
        assert os.path.exists(keeper)
    finally:
        r.close_processes()
        for p in (orphan, keeper):
            if os.path.exists(p):
                os.unlink(p)


def test_import_rollback_unlinks_spills(tmp_path):
    """A failing import_state deletes the transfer's spill files during its
    rollback; spill names are per transfer, and a second export still
    imports."""
    src = StateManager(node_id="src", disk_dir=str(tmp_path / "src"))
    dst = StateManager(node_id="dst", disk_dir=str(tmp_path / "dst"))
    big = torch.arange(4096, dtype=torch.float32)
    src.register("jobA:dep0", {"w": big, "v": big * 2}, Tier.HOST)
    payload = src.export_state("jobA:dep0", max_inline_bytes=1024)
    assert len(payload["spills"]) == 2
    payload2 = src.export_state("jobA:dep0", max_inline_bytes=1024)
    assert set(payload["spills"]).isdisjoint(payload2["spills"])
    for p in payload["spills"] + payload2["spills"]:
        assert os.path.exists(p)
    payload["entries"].append(
        {"key": "jobA:dep0/params/ghost", "nbytes": 8, "version": 0,
         "tier": int(Tier.HOST), "is_bf16": False, "spec": None,
         "path": str(tmp_path / "missing.npy"), "data": None})
    with pytest.raises(FileNotFoundError):
        dst.import_state(payload)
    assert dst.keys_for("jobA:dep0") == []
    for p in payload["spills"]:
        assert not os.path.exists(p)
    assert dst.import_state(payload2) == payload2["bytes"]
    for p in payload2["spills"]:
        assert not os.path.exists(p)


# -------------------------------------------------------- PlexCluster
def test_cluster_process_plane_spawns_a_child_per_group_and_closes():
    c = PlexCluster(n_groups=3, process_plane=True, proc_wpg_factory=STUB,
                    device_plane=cpu_plane())
    r = c.router
    try:
        assert sorted(r.group_procs) == [0, 1, 2]
        pids = {gp.pid() for gp in r.group_procs.values()}
        assert len(pids) == 3 and os.getpid() not in pids
        for gp in r.group_procs.values():
            assert gp.ping(timeout=60.0) is not None
        assert r.process_health() == {0: True, 1: True, 2: True}
        procs = [gp._proc for gp in r.group_procs.values()]
    finally:
        r.close_processes()
    for p in procs:
        p.join(timeout=10)
        assert not p.is_alive()
    assert r.process_health() == {} and my_shm_segments() == []


def test_fail_node_and_checkpoint_all_fail_alike_in_process_mode(tmp_path):
    """The reference's process-mode PlexCluster reaches into state that
    lives in the worker processes: ``checkpoint_all`` / ``restore_all``
    call WPG methods a proxy lacks (AttributeError), and ``fail_node`` on
    a group whose child holds no entry returns []. The port fails (and
    returns) alike, and its message says why."""
    ref_c = RefCluster(n_groups=1, process_plane=True,
                       proc_wpg_factory="repro.launch.stub_wpg:make_busy_wpg")
    c = PlexCluster(n_groups=1, process_plane=True, proc_wpg_factory=STUB,
                    device_plane=cpu_plane())
    try:
        for pkg, cl in ((ref_api, ref_c), (api, c)):
            cl.router.create_deployment(pkg.DeploymentSpec(
                deployment_id="dep0", job_id="job0", model_name="stub",
                role="train"), group_id=0)
        for cl in (ref_c, c):
            assert cl.fail_node(0) == []
        outcomes = []
        for cl in (ref_c, c):
            for call in (lambda: cl.checkpoint_all(str(tmp_path)),
                         lambda: cl.restore_all({"dep0": str(tmp_path)})):
                with pytest.raises(AttributeError) as err:
                    call()
                outcomes.append(str(err.value))
        assert all("_op_" in o for o in outcomes[:2])
        assert all("worker process" in o for o in outcomes[2:])
    finally:
        ref_c.router.close_processes()
        c.router.close_processes()
