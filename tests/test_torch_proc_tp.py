"""Process-mode node groups of several devices, and the host optimizer step
over a slice, on virtual CPU devices.

A ``DevicePlane(devices=[cpu] * 4, slice_size=2)`` gives two 2-device
slices; with ``process_plane=True`` each group's WPGs run in a spawned
child that builds the parent's slice (the same device ids) over its own
view of the devices and runs tensor-parallel there, as thread mode does.

- Greedy GENERATE in a child over a 2-device slice gives thread mode's
  tokens bit for bit, and the JAX package's wherever its top-2 margin is
  above the bf16 logit tolerance (``tests/test_torch_proc_real.py``'s
  rule).
- A live migration between the two children's slices is bit-exact, with
  ``cross_mesh`` True and each entry laid out on the target slice as
  ``StateManager._layout_here`` gives it (qwen2, granite-moe with its
  experts split, mamba2 with ``in_proj`` blocks across the SSD heads).
- A cross-process SYNC_WEIGHTS into target shardings is bit-exact and
  lands in them.
- A PPO step (actor and critic, their gradients across the pipe) and an
  ``OPTIM_STEP(host=True)`` in a child over a slice are bit-exact against
  thread mode.
- ``host_optimizer_step`` over a slice equals the JAX package's on the
  same gathered gradients (``tests/test_torch_ppo.py``'s tolerances), with
  and without DEVICE moments and with ``Sharded`` or whole gradients;
  replicas hold the same bits and a prefetch restores every local block.
- A respawned child gets the same devices and ids; ``env_for_slice`` and
  ``devices_for_slice`` for cards, virtual devices and the CPU; slices
  cross (``MeshSlice.crosses``) unless they hold the same devices under the
  same ids.

Children run one thread each (``OMP_NUM_THREADS``), as the parent does, so
both do the same arithmetic. The file takes about a minute in one
process.
"""
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core.router import Router as JRouter
from repro.core.state_manager import StateManager as JStateManager
from repro.models.common import canonical_flat as j_canonical_flat
from repro.train import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.core import api
from repro_torch.core.cluster import PlexCluster
from repro_torch.core.controller import JobConfig
from repro_torch.core.router import Router
from repro_torch.core.state_manager import StateManager, Tier
from repro_torch.launch.mesh import (DevicePlane, MeshSlice, devices_for_slice,
                                     env_for_slice)
from repro_torch.launch.proc_plane import _ChildState
from repro_torch.models import common, convert
from repro_torch.models import sharding as shd
from repro_torch.models.registry import build_model
from repro_torch.train import optimizer as topt
from test_torch_ep import overrides, replicas_equal

torch.set_num_threads(1)

CPU = torch.device("cpu")
# qwen2-0.5b's head ratio, narrow: 7 query heads and 1 KV head a device
QWEN = (("num_layers", 2), ("d_model", 64), ("num_heads", 14),
        ("num_kv_heads", 2), ("head_dim", 16), ("d_ff", 128),
        ("vocab_size", 128))
N_NEW = 6


@pytest.fixture(autouse=True)
def private_tmp_one_thread(tmp_path, monkeypatch):
    """Spill directories under this test's own directory (other test
    processes use the same node ids), and one thread in each child."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def plane():
    return DevicePlane(devices=[CPU] * 4, slice_size=2)


def spec(mod, dep, job, role, arch="qwen2-0.5b", ovr=QWEN):
    return mod.DeploymentSpec(deployment_id=dep, job_id=job, model_name=arch,
                              role=role, overrides=ovr)


def bits(t) -> torch.Tensor:
    t = torch.as_tensor(t)
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def child_state(gp, prefix):
    """A job's managed state in a child, read without moving it: key ->
    (the gathered value's bytes, the recorded spec, the shape)."""
    payload, _ = gp.call("migrate_export",
                         {"job": prefix, "max_inline": 1 << 40})
    return {e["key"]: (np.asarray(e["data"]).tobytes(), e["spec"],
                       torch.Size(np.shape(e["data"])))
            for e in payload["entries"]}


def layouts(gp, prefix, digests=False):
    return gp.call("probe", {"layouts": prefix,
                             "digests": digests})[0]["layouts"]


def prompts():
    rng = np.random.default_rng(0)
    return rng.integers(3, 128, (3, 10)).astype(np.int32)


# ------------------------------------------------------ the child's view

def test_env_and_devices_for_cards_virtual_devices_and_the_cpu():
    """Cards 2 and 3 are the child's cuda:0 and cuda:1; four virtual
    devices of card 0 are cuda:0 four times; a CPU slice hides every card.
    The ids stay the parent's."""
    cards = DevicePlane(devices=["cuda:0", "cuda:1", "cuda:2", "cuda:3"],
                        slice_size=2).slices()[1]
    assert env_for_slice(cards) == {"CUDA_VISIBLE_DEVICES": "2,3"}
    assert devices_for_slice(cards) == ["cuda:0", "cuda:1"]
    assert cards.device_ids() == (2, 3)
    virt = DevicePlane(devices=["cuda:0"] * 8, slice_size=4).slices()[1]
    assert env_for_slice(virt) == {"CUDA_VISIBLE_DEVICES": "0"}
    assert devices_for_slice(virt) == ["cuda:0"] * 4
    assert virt.device_ids() == (4, 5, 6, 7)
    mixed = MeshSlice(0, ("cuda:3", "cuda:1", "cuda:3", "cuda:1"))
    assert env_for_slice(mixed) == {"CUDA_VISIBLE_DEVICES": "3,1"}
    assert devices_for_slice(mixed) == ["cuda:0", "cuda:1"] * 2
    cpu = plane().slices()[1]
    assert env_for_slice(cpu) == {"CUDA_VISIBLE_DEVICES": ""}
    assert devices_for_slice(cpu) == ["cpu", "cpu"]


def test_slices_cross_unless_they_hold_the_same_devices_and_ids():
    """``MeshSlice.crosses``, the one rule both planes' ``migrate`` read
    ``cross_mesh`` from: two slices of virtual devices on one card share
    the card but not the ids, so a move between them crosses; a slice does
    not cross to itself or to an equal slice, and slices of other cards
    cross."""
    a, b = DevicePlane(devices=["cuda:0"] * 4, slice_size=2).slices()
    assert a.devices == b.devices and a.crosses(b) and b.crosses(a)
    again = DevicePlane(devices=["cuda:0"] * 4, slice_size=2).slices()[0]
    assert not a.crosses(a) and not a.crosses(again)
    c, d = DevicePlane(devices=["cuda:0", "cuda:1", "cuda:2", "cuda:3"],
                       slice_size=2).slices()
    assert c.crosses(d) and c.crosses(a)
    x, y = plane().slices()
    assert x.crosses(y) and not y.crosses(plane().slices()[1])


def test_child_builds_the_parents_slice_and_respawns_with_it():
    """Each group's child holds a MeshSlice with the parent's ids over its
    own devices; a respawned child gets the same devices and ids. A CUDA
    slice in a child that sees no card raises."""
    r = Router(device_plane=plane(), process_plane=True)
    try:
        for g in (0, 1):
            r.create_deployment(spec(api, f"roll{g}", f"J{g}", "rollout"),
                                group_id=g)
        f = r.submit_queued_operation(api.make_op(
            r.deployments["roll1"], api.Op.INIT, 0))
        r.drain()
        f.result()
        gp = r.group_procs[1]
        assert gp.devices == ["cpu", "cpu"] and gp.device_ids == [2, 3]
        assert r.state_managers[1].mesh_slice.device_ids() == (2, 3)
        lay = layouts(gp, "J1:roll1")
        assert lay and all(v["ids"] == [2, 3] and v["devices"] == ["cpu"] * 2
                           for v in lay.values())
        pid = gp.pid()
        gp._proc.kill()
        gp._proc.join(timeout=30)
        assert r.respawn_dead_groups() == [1]
        assert gp.pid() != pid and gp.spawn_count == 2
        assert (gp.devices, gp.device_ids) == (["cpu", "cpu"], [2, 3])
        f = r.submit_queued_operation(api.make_op(
            r.deployments["roll1"], api.Op.INIT, 0))
        r.drain()
        f.result()
        assert {tuple(v["ids"]) for v in layouts(gp, "J1:roll1").values()} \
            == {(2, 3)}
    finally:
        r.close_processes()
    if not torch.cuda.is_available():
        st = _ChildState({"group_id": 0, "node_id": "g0", "slice_index": 0,
                          "devices": ["cuda:0"] * 2,
                          "device_ids": [0, 1]})
        with pytest.raises(RuntimeError, match="sees no CUDA device"):
            st._state_manager(needs_real=True)


# -------------------------------------------------------------- serving

def test_greedy_generate_in_a_child_over_a_slice_matches_thread_mode_and_jax():
    toks = prompts()
    jrouter = JRouter()
    jdep = jrouter.deploy(spec(japi, "roll", "A", "rollout"), group_id=0)
    jdep.init(seed=0)
    jrouter.drain()
    flat = {k: np.asarray(v) for k, v in j_canonical_flat(
        jdep.wpg.params(), is_leaf=lambda x: hasattr(x, "shape")).items()}
    fut = jdep.generate(jnp.asarray(toks), max_new_tokens=N_NEW,
                        temperature=0.0)
    jrouter.drain()
    jtok = np.asarray(fut.result()["tokens"])
    params = convert.params_from_reference(
        flat, get_config("qwen2-0.5b").replace(**dict(QWEN)))
    outs = {}
    for mode in ("thread", "process"):
        r = Router(device_plane=plane(), process_plane=mode == "process")
        try:
            dep = r.deploy(spec(api, "roll", "A", "rollout"), group_id=1)
            dep.call(api.Op.INIT, params=params)
            f = dep.generate(toks, max_new_tokens=N_NEW, temperature=0.0)
            r.drain()
            outs[mode] = f.result()
            if mode == "process":
                assert r.group_procs[1].pid() != os.getpid()
                lay = layouts(r.group_procs[1], "A:roll")
                assert any("model" in str(v["spec"]) for v in lay.values())
        finally:
            r.close_processes()
    for k in ("tokens", "logprobs", "alive"):
        assert torch.equal(outs["process"][k], outs["thread"][k]), k
    ttok = outs["process"]["tokens"].numpy()
    seq = jnp.asarray(np.concatenate([toks, jtok[:, :-1]], 1))
    logits = np.asarray(jdep.wpg.model.forward(
        jdep.wpg.params(), {"tokens": seq})[0],
        np.float32)[:, toks.shape[1] - 1:]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    tol = 2.0 ** -6 * np.abs(logits).max()
    held = 0
    for b in range(ttok.shape[0]):
        for i in range(N_NEW):
            if ttok[b, i] != jtok[b, i]:
                assert margin[b, i] <= tol, (b, i, margin[b, i], tol)
                break
            held += margin[b, i] > tol
    assert held >= ttok.size // 2, held


# ------------------------------------------------ migration and sync

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-3b-a800m",
                                  "mamba2-2.7b"])
def test_migration_between_children_reshards_bit_exact(arch):
    """A train job INITed in group 0's child moves live to group 1's: every
    entry's bytes as they were, ``cross_mesh`` True, each entry laid out on
    the target slice (ids 2 and 3) in the spec ``_layout_here`` gives it
    there, and the job takes a step on its new slice."""
    r = Router(device_plane=plane(), process_plane=True)
    ovr = overrides(arch)
    try:
        dep = r.deploy(spec(api, "A-train", "A", "train", arch, ovr), 0)
        r.ensure_group(1)
        dep.init(seed=1)
        r.drain()
        prefix = dep.wpg.job_prefix
        before = child_state(r.group_procs[0], prefix)
        src_sl = r.state_managers[0].mesh_slice
        moved = r.reassign_job("A", 1)
        assert moved == r.state_managers[1].job_bytes(prefix) > 0
        assert r.migrate_log[-1]["cross_mesh"] is True
        assert r.state_managers[0].job_bytes(prefix) == 0
        after = child_state(r.group_procs[1], prefix)
        assert after.keys() == before.keys()
        assert all(after[k][0] == before[k][0] for k in before)
        here = StateManager(mesh_slice=r.state_managers[1].mesh_slice)
        lay = layouts(r.group_procs[1], prefix)
        split = 0
        for k, (_, spec_, shape) in before.items():
            assert spec_ is not None, k
            want = here._layout_here(shd.NamedSharding(
                src_sl.mesh, shd.P(*spec_)), shape)
            assert tuple(lay[k]["spec"]) == tuple(want.spec), k
            assert lay[k]["ids"] == [2, 3] and lay[k]["tier"] == 0, k
            split += "model" in str(want.spec)
        assert split > 0
        upd = dep.update_actor(_batch(dict(ovr).get("vocab_size", 128)))
        r.drain()
        assert np.isfinite(upd.result()["loss"])
    finally:
        r.close_processes()


def _batch(vocab):
    """A packed GRPO batch of 4 rows of 16 tokens, the last 8 the
    completion."""
    rng = np.random.default_rng(2)
    mask = np.zeros((4, 16), np.float32)
    mask[:, 8:] = 1.0
    return {"tokens": rng.integers(3, vocab, (4, 16)).astype(np.int32),
            "behavior_logprobs": -4.0 * mask,
            "advantages": rng.standard_normal(4).astype(np.float32),
            "loss_mask": mask}


def test_cross_process_sync_into_target_shardings_is_bit_exact():
    """SYNC_WEIGHTS from group 0's child into a rollout deployment in group
    1's child that holds no parameters yet, into target shardings that
    replicate every leaf over the target slice: the synced tree lands in
    them, bit-exact; a second sync writes into the registered tensors."""
    r = Router(device_plane=plane(), process_plane=True)
    try:
        train = r.deploy(spec(api, "A-train", "A", "train"), 0)
        roll = r.deploy(spec(api, "A-roll", "A", "rollout"), 1)
        train.init(seed=1)
        r.drain()
        mesh = r.state_managers[1].mesh_slice.mesh
        tmpl = build_model(get_config("qwen2-0.5b").replace(
            **dict(QWEN))).param_specs()
        targets = common.tree_map(
            lambda _: shd.NamedSharding(mesh, shd.P()), tmpl)
        for _ in range(2):
            f = train.sync_weights(roll, target_shardings=targets)
            r.drain()
            assert f.result()["synced_bytes"] > 0
            src = r.group_procs[0].call("sync_export", {"dep": "A-train"})[0]
            dst = r.group_procs[1].call("sync_export", {"dep": "A-roll"})[0]
            src, dst = common.canonical_flat(src), common.canonical_flat(dst)
            assert src.keys() == dst.keys()
            assert all(torch.equal(bits(src[k]), bits(dst[k])) for k in src)
            lay = layouts(r.group_procs[1], "A:A-roll", digests=True)
            assert lay and all(v["spec"] == () and v["ids"] == [2, 3]
                               for v in lay.values())
            # the children's digests of the gathered bits agree as well
            theirs = layouts(r.group_procs[0], "A:A-train", digests=True)
            assert {k.split("/params/")[1]: v["digest"]
                    for k, v in theirs.items() if "/params/" in k} == {
                k.split("/params/")[1]: v["digest"] for k, v in lay.items()}
    finally:
        r.close_processes()


# ------------------------------------------------------------- training

def _ppo_run(process_plane):
    """One PPO step (actor and critic) on a 2-device group, then one
    FORWARD_BACKWARD + OPTIM_STEP(host=True) of the actor and a prefetch.
    Returns the metrics, the step's result and the actor's parameters."""
    c = PlexCluster(n_groups=1, device_plane=plane(), devices_per_group=2,
                    process_plane=process_plane)
    try:
        ctl = c.add_job(JobConfig(
            job_id="P", model_name="qwen2-0.5b", steps=1, batch_size=4,
            group_size=2, max_new_tokens=4, seq_len=24, overrides=QWEN,
            seed=3), group_id=0, algo="ppo")
        billing = c.run(interleave=True)
        assert billing["P"].steps == 1
        r, dep = c.router, ctl.dep
        # PPO's token-level advantages
        adv = np.random.default_rng(4).standard_normal((4, 16)).astype(
            np.float32)
        fb = dep.forward_backward(dict(_batch(128), advantages=adv),
                                  objective="ppo")
        st = dep.optim_step(fb.then(lambda res: res["grads"]), host=True)
        r.drain()
        assert st.result()["host"] is True
        if process_plane:
            params = r.group_procs[0].call("sync_export",
                                           {"dep": "P-train"})[0]
        else:
            params = dep.wpg.host_params()
            sm = dep.wpg.sm
            for k in sm.keys_for(dep.wpg.job_prefix, "params"):
                assert sm.entries[k].tier == Tier.HOST
                replicas_equal(sm.entries[k].ref, k)
        dep.wpg.ensure_resident()
        return ctl.metrics_log, st.result(), common.canonical_flat(params)
    finally:
        c.router.close_processes()


def test_ppo_and_host_step_in_a_child_over_a_slice_equal_thread_mode():
    thread, proc = _ppo_run(False), _ppo_run(True)
    assert proc[0] == thread[0] and proc[1] == thread[1]
    assert {"pg_loss", "value_loss", "step"} <= proc[0][0].keys()
    assert proc[2].keys() == thread[2].keys()
    for k in proc[2]:
        assert torch.equal(bits(proc[2][k]), bits(thread[2][k])), k


def _slice_tree(seed, mesh, bf16=("wb",)):
    """A small tree, split, replicated and bf16 leaves, laid out on
    ``mesh``; returns (whole CPU tensors, Sharded leaves)."""
    rng = np.random.default_rng(seed)
    whole = {"w1": rng.standard_normal((8, 16)).astype(np.float32),
             "nested": {"w2": rng.standard_normal(4).astype(np.float32),
                        "wb": rng.standard_normal((3, 6)).astype(
                            np.float32)}}
    specs = {"w1": shd.P(None, "model"),
             "nested": {"w2": shd.P(), "wb": shd.P(None, "model")}}

    def leaf(path, v):
        t = torch.from_numpy(v.copy())
        return t.bfloat16() if path.endswith(bf16) else t

    whole = common.canonical_unflatten(whole, {
        k: leaf(k, v) for k, v in common.canonical_flat(whole).items()})
    laid = common.canonical_unflatten(whole, {
        k: shd.shard(v, shd.NamedSharding(mesh, common.canonical_flat(
            specs)[k])) for k, v in common.canonical_flat(whole).items()})
    return whole, laid


def _jax_tree(tree):
    return common.tree_map(
        lambda t: jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tree)


@pytest.mark.parametrize("grads_as", ["Sharded", "whole"])
@pytest.mark.parametrize("moments", ["created on HOST", "on DEVICE"])
def test_host_optimizer_step_over_a_slice_matches_jax(moments, grads_as):
    """Two host steps over a 2-device slice against the JAX StateManager's
    on the same gathered gradients: parameters (f32, and bf16 split over
    the slice), both moments and the step, at test_torch_ppo.py's
    tolerances. The parameters' host copies keep their layout, replicas
    the same bits; a prefetch restores every local block on its device.
    Moments the device optimizer made over the slice stay ``Sharded``
    and on DEVICE."""
    sl = plane().slices()[1]
    whole, laid = _slice_tree(0, sl.mesh)
    jsm, tsm = JStateManager(), StateManager(mesh_slice=sl)
    jsm.register("job", _jax_tree(whole))
    tsm.register("job", laid)
    if moments == "on DEVICE":
        jsm.register("job", jopt.init(_jax_tree(whole)), prefix="opt")
        tsm.register("job", topt.init(laid)._asdict(), prefix="opt")
    layout = {k: e.sharding for k, e in tsm.entries.items()}
    for i in range(2):
        gwhole, glaid = _slice_tree(10 + i, sl.mesh, bf16=())
        js = jsm.host_optimizer_step("job", _jax_tree(gwhole), None, lr=1e-2)
        ts = tsm.host_optimizer_step(
            "job", glaid if grads_as == "Sharded" else gwhole, None, lr=1e-2)
        assert ts == js == i + 1
    assert set(tsm.entries) == set(jsm.entries)
    for k, e in tsm.entries.items():
        want = np.asarray(jnp.asarray(jsm.entries[k].ref, jnp.float32))
        got = shd.gather(e.ref, "cpu").float().numpy() \
            if isinstance(e.ref, shd.Sharded) else e.ref.float().numpy()
        if k == "job/params/nested/wb":
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        if "/params/" in k:
            assert e.tier == Tier.HOST and e.sharding == layout[k], k
            assert e.ref.sharding == layout[k], k
            replicas_equal(e.ref, k)
        elif "/opt/mu/" in k or "/opt/nu/" in k:
            if moments == "on DEVICE":
                assert isinstance(e.ref, shd.Sharded) and e.tier == Tier.DEVICE
                replicas_equal(e.ref, k)
            else:
                assert torch.is_tensor(e.ref) and e.ref.dtype == torch.float32
                assert e.tier == Tier.HOST
    values = {k: shd.gather(tsm.entries[k].ref, "cpu")
              for k in tsm.keys_for("job", "params")}
    tsm.prefetch(tsm.keys_for("job", "params"))
    for k, v in values.items():
        e = tsm.entries[k]
        assert e.tier == Tier.DEVICE and e.ref.sharding == layout[k], k
        for pos, (loc, d) in enumerate(zip(e.ref.locals, sl.devices)):
            assert loc.device == d
            assert torch.equal(bits(loc), bits(v[layout[k].slices(pos,
                                                                  v.shape)]))
