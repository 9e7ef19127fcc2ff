"""The port's process plane with real WorkerProcessGroups in the children,
held against the port's thread mode and the JAX package on the CPU.

The children run on CPU slices (``DevicePlane(devices=["cpu"])``: each child
is told to run on the CPU and sees no card) at qwen2-0.5b cut to two narrow
layers; parameters come from the JAX package through ``models/convert.py``
where a test compares with it. Each child is held to one thread
(``OMP_NUM_THREADS``), as the parent, so both do the same arithmetic.

- Greedy GENERATE in a child gives the tokens of the port's thread mode
  bit for bit, and the JAX package's wherever its top-2 margin is above the
  bf16 logit tolerance (tests/test_torch_serve.py's rule).
- A weight sync between two children is bit-exact; ``reassign_job`` moves
  a job to a third child, which serves the same greedy tokens.
- ``export_state`` of a converted training job gives the reference's keys,
  sizes, versions, tiers, ``is_bf16`` flags and bytes, and the reference
  imports its spill files.
- An import that fails in a child rolls back and unlinks the transfer's
  spill files; an importer killed mid-migration leaves the source the
  owner, no spill and no /dev/shm residue. ``fail_node`` fails in process
  mode, as the reference's does.
"""
import glob
import os
import signal
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core.router import Router as JRouter
from repro.core.state_manager import StateManager as JStateManager
from repro.core.state_manager import Tier as JTier
from repro.models.common import canonical_flat as j_canonical_flat
from repro_torch.configs import get_config
from repro_torch.core import api
from repro_torch.core.cluster import PlexCluster
from repro_torch.core.router import Router
from repro_torch.core.state_manager import Tier
from repro_torch.launch import shm_transport as shmt
from repro_torch.launch.mesh import DevicePlane
from repro_torch.launch.proc_plane import GroupProcessError
from repro_torch.models import convert
from repro_torch.models.common import canonical_flat
from repro_torch.rl import data as data_lib

torch.set_num_threads(1)

OVERRIDES = (("num_layers", 2), ("d_model", 64), ("num_heads", 14),
             ("num_kv_heads", 2), ("head_dim", 16), ("d_ff", 128),
             ("vocab_size", 128))
N_NEW = 6


@pytest.fixture(autouse=True)
def private_tmp_one_thread(tmp_path, monkeypatch):
    """Spill directories (``<tmp>/plexrl_<node>``, here and in the
    children) under this test's own directory, since other test processes
    use the same node ids; and one thread in each child."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def cpu_plane():
    return DevicePlane(devices=[torch.device("cpu")])


def spec(mod, dep, job, role):
    return mod.DeploymentSpec(deployment_id=dep, job_id=job,
                              model_name="qwen2-0.5b", role=role,
                              overrides=OVERRIDES)


def prompts():
    p, _ = next(data_lib.MathDataset(seed=0).batches(3, 10))
    return np.asarray(p, np.int32) % 128


def my_shm_segments():
    prefix = f"pxl{os.getpid()}g"
    try:
        return sorted(n for n in os.listdir(shmt.SHM_DIR)
                      if n.startswith(prefix))
    except FileNotFoundError:
        return []


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bit pattern (bf16 as int16), for bit-exact compares."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def same_tree(a, b) -> bool:
    a, b = canonical_flat(a), canonical_flat(b)
    return a.keys() == b.keys() and all(
        torch.equal(bits(a[k]), bits(b[k])) for k in a)


def jax_params(dep_spec, seed):
    router = JRouter()
    dep = router.deploy(dep_spec, group_id=0)
    dep.init(seed=seed)
    router.drain()
    flat = {k: np.asarray(v) for k, v in j_canonical_flat(
        dep.wpg.params(), is_leaf=lambda x: hasattr(x, "shape")).items()}
    return router, dep, flat


def greedy(dep, toks):
    fut = dep.generate(toks, max_new_tokens=N_NEW, temperature=0.0)
    dep.router.run_until_idle(timeout=280)
    return fut.result()


def test_greedy_generate_in_process_mode_matches_thread_mode_and_jax():
    toks = prompts()
    jrouter, jdep, flat = jax_params(spec(japi, "roll", "A", "rollout"), 0)
    fut = jdep.generate(jnp.asarray(toks), max_new_tokens=N_NEW,
                        temperature=0.0)
    jrouter.drain()
    jtok = np.asarray(fut.result()["tokens"])

    params = convert.params_from_reference(
        flat, get_config("qwen2-0.5b").replace(**dict(OVERRIDES)))
    outs = {}
    for mode in ("thread", "process"):
        r = Router(device_plane=cpu_plane(), process_plane=mode == "process")
        try:
            dep = r.deploy(spec(api, "roll", "A", "rollout"), group_id=0)
            dep.call(api.Op.INIT, params=params)
            outs[mode] = greedy(dep, toks)
            if mode == "process":
                assert r.group_procs[0].pid() != os.getpid()
                assert [e[0] for e in dep.wpg.exec_log] == ["init",
                                                            "generate"]
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
    margin, tol = top2[..., 1] - top2[..., 0], 2.0 ** -6 * np.abs(
        logits).max()
    held = 0
    for b in range(ttok.shape[0]):
        for i in range(N_NEW):
            if ttok[b, i] != jtok[b, i]:
                assert margin[b, i] <= tol, (b, i, margin[b, i], tol)
                break
            held += margin[b, i] > tol
    assert held >= ttok.size // 2, held


def test_real_wpg_cross_process_sync_and_migration():
    """INIT in two children, a weight sync between them (bit-exact), a
    GENERATE in the target child, then a live migration of the whole job
    to a third child, which serves the same greedy tokens from the same
    bits."""
    r = Router(device_plane=cpu_plane(), process_plane=True)
    train = spec(api, "train0", "jobA", "train")
    roll = spec(api, "roll0", "jobA", "rollout")
    toks = prompts()
    try:
        d_train = r.deploy(train, group_id=0)
        d_roll = r.deploy(roll, group_id=1)
        f_a = d_train.init(seed=0)
        f_b = d_roll.init(seed=1)
        r.run_until_idle(timeout=280)
        assert f_a.result()["params"] == f_b.result()["params"] > 0
        export = {g: lambda g=g, d=d: r.group_procs[g].call(
            "sync_export", {"dep": d})[0]
            for g, d in ((0, "train0"), (1, "roll0"))}
        assert not same_tree(export[0](), export[1]())
        f_sync = d_train.sync_weights(d_roll)
        r.run_until_idle(timeout=280)
        assert f_sync.result()["synced_bytes"] > 0
        want = export[0]()
        assert same_tree(export[1](), want)
        out = greedy(d_roll, toks)
        assert isinstance(out["tokens"], torch.Tensor)
        assert out["tokens"].shape == (toks.shape[0], N_NEW)
        moved = r.reassign_job("jobA", 2, timeout=280)
        assert moved == sum(e["bytes"] for e in r.migrate_log) > 0
        assert r.state_managers[2].job_bytes("jobA:train0") > 0
        assert r.state_managers[0].job_bytes("jobA:train0") == 0
        assert r.group_of["train0"] == r.group_of["roll0"] == 2
        assert same_tree(r.group_procs[2].call(
            "sync_export", {"dep": "roll0"})[0], want)
        again = greedy(d_roll, toks)
        assert torch.equal(again["tokens"], out["tokens"])
    finally:
        r.close_processes()
    assert my_shm_segments() == []


def test_export_state_matches_the_reference(tmp_path):
    """A training job converted from the JAX package: the port's export
    payload has the reference's keys, nbytes, versions, tiers and bf16
    flags, the same bytes inline and in its spill files, and the reference
    imports those files."""
    jrouter, jdep, flat = jax_params(spec(japi, "train", "A", "train"), 0)
    jsm = jrouter.state_managers[0]
    jsm.disk_dir = str(tmp_path / "jax")
    r = Router(device_plane=cpu_plane())
    dep = r.deploy(spec(api, "train", "A", "train"), group_id=0)
    dep.call(api.Op.INIT,
             params=convert.params_from_reference(flat, dep.wpg.cfg))
    r.drain()
    sm = r.state_managers[0]
    prefix = dep.wpg.job_prefix
    # params on HOST, the AdamW state on DEVICE, on both sides
    jsm.offload(jsm.keys_for(prefix, "params"), JTier.HOST)
    sm.offload(sm.keys_for(prefix, "params"), Tier.HOST)
    limit = 8 << 10
    theirs = {e["key"]: e for e in jsm.export_state(prefix, limit)["entries"]}
    payload = sm.export_state(prefix, limit)
    mine = {e["key"]: e for e in payload["entries"]}
    assert mine.keys() == theirs.keys() and len(mine) > 10
    for k, e in mine.items():
        t = theirs[k]
        for f in ("nbytes", "version", "tier", "is_bf16"):
            assert e[f] == t[f], (k, f)
        assert (e["path"] is None) == (t["path"] is None), k
        a = np.load(e["path"]) if e["path"] else e["data"]
        b = np.load(t["path"]) if t["path"] else np.asarray(t["data"])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert any(e["is_bf16"] for e in mine.values())
    assert any(e["path"] for e in mine.values())
    assert {e["tier"] for e in mine.values()} == {int(Tier.DEVICE),
                                                   int(Tier.HOST)}
    # the reference adopts the port's payload, spill files and all
    jdst = JStateManager(node_id="dst", disk_dir=str(tmp_path))
    assert jdst.import_state(payload) == payload["bytes"]
    assert not [p for p in payload["spills"] if os.path.exists(p)]
    for k, e in jsm.entries.items():
        got = np.asarray(jax.device_get(jdst.entries[k].ref))
        assert got.tobytes() == np.asarray(jax.device_get(e.ref)).tobytes()


def test_import_in_a_child_rolls_back_and_unlinks_spills():
    """A migrate_import that fails in the destination child (a ghost entry
    after the real ones) leaves no entry there and deletes the transfer's
    spill files; the source still owns the job. ``fail_node`` on a group
    holding state fails, as the reference's does in process mode, saying
    why."""
    c = PlexCluster(n_groups=2, process_plane=True, device_plane=cpu_plane())
    r = c.router
    try:
        d = r.deploy(spec(api, "train0", "jobA", "train"), group_id=0)
        d.init(seed=0)
        r.run_until_idle(timeout=280)
        with pytest.raises(AttributeError, match="worker process"):
            c.fail_node(0)
        src, dst = r.group_procs[0], r.group_procs[1]
        before = r.state_managers[0].job_bytes("jobA:train0")
        payload, _ = src.call("migrate_export", {"job": "jobA:train0",
                                                 "max_inline": 4096},
                              decode_reply=False)
        assert payload["spills"]
        payload["entries"].append(
            {"key": "jobA:train0/params/ghost", "nbytes": 8, "version": 0,
             "tier": int(Tier.HOST), "is_bf16": False, "spec": None,
             "path": payload["spills"][0] + ".missing", "data": None})
        with pytest.raises(RuntimeError, match="group 1 process.*FileNotF"):
            dst.call("migrate_import", {"payload": payload})
        src.release_segments(shmt.refs_in(payload))
        assert r.state_managers[1].keys_for("jobA:train0") == []
        assert not [p for p in payload["spills"] if os.path.exists(p)]
        assert r.state_managers[0].job_bytes("jobA:train0") == before
    finally:
        r.close_processes()
    assert my_shm_segments() == []


@pytest.mark.skipif(not shmt.shm_available(),
                    reason="no usable shared memory on this host")
def test_migrate_importer_death_cleans_spills_and_segments(monkeypatch):
    """Killing the importing child with spill files, then shm descriptors,
    in flight: each migration raises, the source keeps its state, the
    transfer's ``export__`` spills are deleted, and the respawn and close
    leave no /dev/shm residue."""
    # the tiny model's tensors ride shm: each GroupProcess takes its
    # threshold from the transport's default when it is built
    monkeypatch.setattr(shmt, "DEFAULT_THRESHOLD", 1024)
    r = Router(device_plane=cpu_plane(), process_plane=True)
    try:
        r.create_deployment(spec(api, "train0", "jobA", "train"), group_id=0)
        r.create_deployment(spec(api, "other0", "jobB", "train"), group_id=1)
        f = r.submit_queued_operation(api.make_op(
            r.deployments["train0"], api.Op.INIT, 0))
        r.run_until_idle(timeout=280)
        assert f.result()["params"] > 0
        src = r.state_managers[0]
        before = src.job_bytes("jobA:train0")
        assert before > 0
        os.kill(r.group_procs[1].pid(), signal.SIGKILL)
        r.group_procs[1]._proc.join(timeout=30)
        with pytest.raises(GroupProcessError, match="worker process died"):
            src.migrate("jobA:train0", r.state_managers[1],
                        max_inline_bytes=2048)
        assert src.job_bytes("jobA:train0") == before
        assert glob.glob(os.path.join(r.group_procs[0].spill_dir(),
                                      "export__*")) == []
        with pytest.raises(GroupProcessError, match="worker process died"):
            src.migrate("jobA:train0", r.state_managers[1])
        assert src.job_bytes("jobA:train0") == before
        assert [n for n in my_shm_segments()
                if n.startswith(f"pxl{os.getpid()}g0s1c")]
        assert r.respawn_dead_groups() == [1]
        assert r.process_health() == {0: True, 1: True}
    finally:
        r.close_processes()
    assert my_shm_segments() == []
