"""The port's device plane on virtual CPU devices: mesh-slice carving and
leasing, sharded state across slices (a bit-identical reshard with a
HOST-tier entry riding along, a rollback mid-migration, a prefetch that
restores the recorded spec, the DISK tier), and the reference's e2e path:
two real-model GRPO jobs on disjoint slices, one migrated live across
slices, params bit-identical and billing conserved
(``tests/test_device_plane.py``).

The reference runs these on ``--xla_force_host_platform_device_count=8``
virtual devices and skips them under tier-1; the port's virtual devices
are an explicit device list, ``[torch.device("cpu")] * 8``, so these run
(and assert) here. A device's id is its position in the plane's list.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import api
from repro_torch.core.cluster import PlexCluster
from repro_torch.core.controller import JobConfig
from repro_torch.core.router import Router
from repro_torch.core.state_manager import StateManager, Tier
from repro_torch.core.worker import WorkerProcessGroup
from repro_torch.launch.mesh import (DevicePlane, MeshSlice, env_for_slice,
                                     make_local_mesh)
from repro_torch.models import common
from repro_torch.models import sharding as shd

torch.set_num_threads(1)

CPU = torch.device("cpu")
N_DEV = 8
TINY = (("num_layers", 2), ("d_model", 32), ("num_heads", 4),
        ("num_kv_heads", 2), ("head_dim", 8), ("d_ff", 64),
        ("vocab_size", 64), ("tie_embeddings", True))


def _plane(**kw):
    return DevicePlane(devices=[CPU] * N_DEV, **kw)


# ------------------------------------------------------------ DevicePlane

def test_carve_slices_disjoint_and_cover():
    plane = _plane()
    slices = plane.carve(n_groups=2)
    seen = set()
    for s in slices:
        ids = set(s.device_ids())
        assert ids.isdisjoint(seen), "slices must be disjoint"
        seen |= ids
        assert s.mesh.axis_names == ("data", "model")
        assert s.mesh.shape == {"data": 1, "model": s.n_devices}
        assert s.device == s.devices[0] == CPU
    assert seen == set(range(N_DEV))
    assert [s.n_devices for s in slices] == [4, 4]


def test_acquire_is_idempotent_and_deterministic():
    a, b = _plane(slice_size=N_DEV // 2), _plane(slice_size=N_DEV // 2)
    for plane in (a, b):
        s0 = plane.slice_for_group(0)
        assert plane.slice_for_group(0) is s0     # idempotent per group
    # identical acquisition order -> identical slice assignment (the
    # VirtualClock replay contract: mesh binding is clock-free)
    assert a.slice_for_group(1).index == b.slice_for_group(1).index
    assert a.domains() == b.domains() == {0: 0, 1: 1}


def test_release_returns_lease():
    plane = _plane()
    s0 = plane.slice_for_group(0)
    plane.release(0)
    assert plane.slice_index(0) is None
    # the freed slice is the lowest-index free slice again
    assert plane.slice_for_group(7).index == s0.index


def test_oversubscribed_groups_share_least_loaded_slice():
    plane = _plane(slice_size=N_DEV)          # exactly one slice
    s0 = plane.slice_for_group(0)
    s1 = plane.slice_for_group(1)             # no free slice: shared
    assert s0 is s1 and s0.device_ids() == tuple(range(N_DEV))
    with pytest.raises(RuntimeError, match="re-carve"):
        plane.carve(2)


def test_make_local_mesh_and_slices_validate_device_count():
    with pytest.raises(ValueError) as ei:
        make_local_mesh(data=N_DEV + 1, model=1, devices=[CPU] * N_DEV)
    assert str(N_DEV + 1) in str(ei.value) and "virtual" in str(ei.value)
    mesh = make_local_mesh(2, 4, devices=[CPU] * N_DEV)
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8
    # a slice never quietly shrinks to the devices there are
    with pytest.raises(ValueError, match="slice of 16 devices"):
        _plane(slice_size=16).slice_for_group(0)


def test_one_device_slices_and_env_for_slice():
    legacy = MeshSlice(3, CPU)
    assert legacy.devices == (CPU,) and legacy.n_devices == 1
    assert legacy.device_ids() == (0,) and legacy.mesh.size == 1
    cards = DevicePlane(devices=["cuda:0", "cuda:1", "cuda:0", "cuda:1"],
                        slice_size=2).slice_for_group(0)
    assert env_for_slice(cards) == {"CUDA_VISIBLE_DEVICES": "0,1"}
    assert env_for_slice(legacy) == {"CUDA_VISIBLE_DEVICES": ""}


# ------------------------------------------- cross-slice StateManager moves

def _two_slice_sms():
    plane = _plane(slice_size=N_DEV // 2)
    src = StateManager(node_id="src", mesh_slice=plane.slice_for_group(0))
    dst = StateManager(node_id="dst", mesh_slice=plane.slice_for_group(1))
    return src, dst


def _sharded_tree(mesh):
    rng = np.random.RandomState(0)
    host = {
        "w": torch.from_numpy(rng.rand(8, N_DEV * 4).astype(np.float32)),
        "b": torch.from_numpy(rng.rand(32).astype(np.float32)),
        "scale": torch.from_numpy(rng.rand(4, 4).astype(np.float32)),
    }
    specs = {"w": shd.P(None, "model"), "b": shd.P(), "scale": shd.P()}
    dev = {k: shd.shard(v, shd.NamedSharding(mesh, specs[k]))
           for k, v in host.items()}
    return host, dev


def _global(tree):
    return {k: shd.gather(v, "cpu") for k, v in tree.items()}


def test_cross_slice_migrate_bit_identical_with_host_tier_entry():
    src, dst = _two_slice_sms()
    host, dev = _sharded_tree(src.mesh_slice.mesh)
    src.register("job:dep", dev, Tier.DEVICE, "params")
    mom = {k: v.map(torch.zeros_like) for k, v in dev.items()}
    src.register("job:dep", {"mu": mom}, Tier.DEVICE, "opt")
    # a host-tier (offloaded) entry rides along, in its pinned buffers
    src.offload(["job:dep/params/b"], Tier.HOST)
    assert src.entries["job:dep/params/b"].tier == Tier.HOST
    assert all(t.device == CPU for t in
               src.entries["job:dep/params/b"].ref.locals)

    tmpl = {k: None for k in host}
    before = _global(src.gather("job:dep", tmpl, "params"))
    moved = src.migrate("job:dep", dst)
    assert moved == sum(v.numel() * 4 for v in host.values()) * 2
    assert not src.keys_for("job:dep")
    assert src.last_migrate["bytes"] == moved
    assert src.last_migrate["cross_mesh"] is True

    after = _global(dst.gather("job:dep", tmpl, "params"))
    for k in host:
        assert torch.equal(before[k], after[k]) and \
            torch.equal(after[k], host[k])
    # device-tier entries landed RESHARDED onto the destination slice
    dst_ids = set(dst.mesh_slice.device_ids())
    for key, e in dst.entries.items():
        ids = {int(i) for i in e.sharding.mesh.device_ids.flat}
        assert ids <= dst_ids, key
    # the sharded leaf kept its PartitionSpec across the reshard
    w = dst.entries["job:dep/params/w"]
    assert w.tier == Tier.DEVICE
    assert tuple(w.ref.sharding.spec) == (None, "model")
    assert [tuple(t.shape) for t in w.ref.locals] == [(8, 8)] * 4
    # the HOST entry comes up on the destination's slice
    dst.prefetch(["job:dep/params/b"])
    b = dst.entries["job:dep/params/b"]
    assert b.ref.sharding.mesh == dst.mesh_slice.mesh
    assert torch.equal(shd.gather(b.ref), host["b"])


def test_mid_migration_failure_rolls_back():
    src, dst = _two_slice_sms()
    host, dev = _sharded_tree(src.mesh_slice.mesh)
    src.register("job:dep", dev, Tier.DEVICE, "params")
    keys_before = set(src.keys_for("job:dep"))
    tmpl = {k: None for k in host}
    before = _global(src.gather("job:dep", tmpl, "params"))

    class _FailingEntries(dict):
        inserts = 0

        def __setitem__(self, k, v):
            type(self).inserts += 1
            if type(self).inserts == 2:
                raise RuntimeError("injected mid-migration failure")
            super().__setitem__(k, v)

    failing = _FailingEntries()
    failing.update(dst.entries)
    dst.entries = failing
    with pytest.raises(RuntimeError, match="injected"):
        src.migrate("job:dep", dst)
    # source untouched (all tiers), destination holds no partial copies
    assert set(src.keys_for("job:dep")) == keys_before
    again = _global(src.gather("job:dep", tmpl, "params"))
    for k in host:
        assert torch.equal(before[k], again[k])
    assert not [k for k in dst.entries if k.startswith("job:dep/")]
    assert src.last_migrate is None


@pytest.mark.parametrize("tier", [Tier.HOST, Tier.DISK])
def test_prefetch_restores_recorded_spec_on_own_slice(tier, tmp_path):
    src, _ = _two_slice_sms()
    src.disk_dir = str(tmp_path)
    host, dev = _sharded_tree(src.mesh_slice.mesh)
    keys = src.register("job:dep", dev, Tier.DEVICE, "params")
    src.offload(keys, tier)
    src.prefetch(keys)
    w = src.entries["job:dep/params/w"]
    assert w.tier == Tier.DEVICE
    assert tuple(w.ref.sharding.spec) == (None, "model")
    ids = {int(i) for i in w.ref.sharding.mesh.device_ids.flat}
    assert ids == set(src.mesh_slice.device_ids())
    for k in host:
        assert torch.equal(shd.gather(src.entries[f"job:dep/params/{k}"].ref),
                           host[k])
    # a replicated leaf keeps distinct copies: an in-place write of one
    # leaves the others
    b = src.entries["job:dep/params/b"].ref
    assert len({t.data_ptr() for t in b.locals}) == len(b.locals)


# ----------------------------------------------- e2e acceptance (8 devices)

def _job(job_id, seed, steps=1):
    return JobConfig(job_id=job_id, model_name="qwen2-0.5b", steps=steps,
                     batch_size=4, group_size=2, max_new_tokens=4,
                     seq_len=24, overrides=TINY, seed=seed)


def _sharding_device_ids(shardings):
    return {int(i)
            for s in common.canonical_flat(shardings).values()
            for i in s.mesh.device_ids.flat}


def test_e2e_disjoint_slices_and_cross_slice_live_migration():
    """Two real-model jobs on groups holding DISJOINT mesh slices; one is
    live-migrated across slices with params bit-identical and billing
    conserved."""
    c = PlexCluster(n_groups=2, devices_per_group=4, device_plane=_plane())
    c.add_job(_job("jobM1", 1), group_id=0)
    c.add_job(_job("jobM2", 2), group_id=1)
    c.run(interleave=True)

    assert c.router.mesh_domains() == {0: 0, 1: 1}
    w1 = c.router.wpgs["jobM1-train"]
    w2 = c.router.wpgs["jobM2-train"]
    ids1 = _sharding_device_ids(w1.param_shardings())
    ids2 = _sharding_device_ids(w2.param_shardings())
    assert len(ids1) == 4 and len(ids2) == 4
    assert ids1.isdisjoint(ids2), "groups must execute on disjoint hardware"
    # the WPGs' live params actually reside on their group's slice
    for wpg, ids in ((w1, ids1), (w2, ids2)):
        sm = wpg.sm
        for k in sm.keys_for(wpg.job_prefix, "params"):
            e = sm.entries[k]
            if e.tier == Tier.DEVICE:
                assert isinstance(e.ref, shd.Sharded), k
                assert {int(i) for i in
                        e.ref.sharding.mesh.device_ids.flat} <= ids
    for c_ in c.controllers.values():
        assert c_.steps_completed == 1
        assert all(np.isfinite(m["loss"]) for m in c_.metrics_log)

    before = common.canonical_flat(w1.host_params())
    with c._bill_lock:
        c._bill_from_logs()
    busy_before = c.billing["jobM1"].busy_seconds
    assert busy_before > 0.0

    moved = c.reassign_job("jobM1", 1)
    assert moved > 0
    assert c.router.group_of["jobM1-train"] == 1
    assert c.router.migrate_log[-1]["cross_mesh"] is True

    after = common.canonical_flat(w1.host_params())
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k
    # migrated state now lives on group 1's slice
    ids_after = {int(i) for leaf in common.canonical_flat(w1.params())
                 .values() for i in leaf.sharding.mesh.device_ids.flat}
    assert ids_after and ids_after <= ids2
    # billing conserved: migration itself bills nothing, cursors survive
    with c._bill_lock:
        c._bill_from_logs()
    assert c.billing["jobM1"].busy_seconds == pytest.approx(busy_before)
    # and the migrated job steps on its new slice
    c.controllers["jobM1"].cfg.steps = 2
    c.run(interleave=True)
    assert c.controllers["jobM1"].steps_completed == 2


# -------------------------------------------------- what is still queued

@pytest.mark.parametrize("arch,part", [
    ("granite-moe-3b-a800m", 1), ("gemma2-27b", 2), ("whisper-large-v3", 2),
    ("llama-3.2-vision-90b", 2), ("mamba2-2.7b", 3), ("zamba2-7b", 3)])
def test_other_families_on_several_devices_raise_naming_their_part(arch,
                                                                   part):
    """A family whose part is still queued raises, naming it, at INIT on
    a 2-device slice; one whose part is ported (1: MoE, 3: mamba2 and
    zamba2) lays out its state there (the shardings alone: nothing
    allocated at full width)."""
    sl = _plane(slice_size=2).slice_for_group(0)
    wpg = WorkerProcessGroup(api.DeploymentSpec(
        deployment_id="d", job_id="j", model_name=arch, role="rollout"),
        StateManager(mesh_slice=sl))
    if part in shd.PARTS:
        with pytest.raises(NotImplementedError,
                           match=f"item 5, sharding, part {part}"):
            wpg.execute(api.make_op(wpg.spec, api.Op.INIT, 0))
    else:
        assert shd.tp_unsupported(get_config(arch)) is None
        st = common.canonical_flat(wpg.param_shardings())
        assert all(v.mesh == sl.mesh for v in st.values())
        assert any("model" in tuple(v.spec) for v in st.values())
    assert get_config(arch).name == arch


def test_process_mode_group_of_several_devices_raises_naming_part_4():
    """Part 4 is ported, so the group no longer raises: in process mode a
    group of several devices spawns its child on its slice (its devices
    and the parent's ids) and holds the slice's lease until it retires."""
    router = Router(device_plane=_plane(slice_size=2), process_plane=True)
    try:
        sm = router.ensure_group(1)
        gp = router.group_procs[1]
        assert sm.mesh_slice.device_ids() == (0, 1)
        assert gp.devices == ["cpu", "cpu"] and gp.device_ids == [0, 1]
        assert gp.env == {"CUDA_VISIBLE_DEVICES": ""}
        assert gp.pid() != os.getpid() and gp.ping(timeout=120) is not None
        assert router.device_plane.domains() == {1: 0}
        assert 4 not in shd.PARTS and 7 not in shd.PARTS
        router.retire_group(1)
        assert router.device_plane.domains() == {} and not router.group_procs
    finally:
        router.close_processes()
