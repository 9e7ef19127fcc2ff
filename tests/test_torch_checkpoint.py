"""The port's checkpoints and the StateManager's DISK tier, held against
the JAX package on the CPU.

A checkpoint is the reference's on-disk format (``metadata.json``
committed atomically, ``shard_<i>.npz`` of at most 512 MiB, keys with
``/`` -> ``__``, bf16 as a uint16 view with dtype ``"bfloat16"``), so one
written by either package restores in the other, bit for bit. The DISK
tier tests mirror tests/test_state_manager.py on the port's StateManager.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.models.common import canonical_flat as j_canonical_flat
from repro.train import checkpoint as jckpt
from repro_torch.core import api
from repro_torch.core.cluster import PlexCluster
from repro_torch.core.controller import JobConfig
from repro_torch.core.state_manager import StateManager, Tier
from repro_torch.launch.mesh import DevicePlane
from repro_torch.models import common, convert
from repro_torch.models.registry import build_model
from repro_torch.train import checkpoint as tckpt
from test_torch_train import IS_ARR, OVERRIDES, _port_cfg, _reference_params

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _bits(t):
    """A tensor's bit pattern, as an integer numpy array."""
    t = t.detach().cpu().contiguous()
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()]).numpy()


def _equal_bits(a, b, what=""):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w1": torch.randn((8, 16), generator=g),
            "wb": torch.randn((3, 5), generator=g).bfloat16(),
            "nested": {"w2": torch.ones(4),
                       "step": torch.tensor(7, dtype=torch.int32)}}


# ------------------------------------------------------------ checkpoints

def test_checkpoint_round_trip_is_bit_exact_across_shards(tmp_path,
                                                          monkeypatch):
    """bf16, f32 and int leaves; a shard limit of 600 B splits them over
    shards, as 512 MiB splits a large model."""
    monkeypatch.setattr(tckpt, "_SHARD_BYTES", 300)
    tree = _tree()
    path = tckpt.save(str(tmp_path / "c"), tree, step=5,
                      extra_meta={"job_id": "j"})
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    assert meta["step"] == 5 and meta["job_id"] == "j"
    assert meta["tensors"]["wb"]["dtype"] == "bfloat16"
    assert len({t["shard"] for t in meta["tensors"].values()}) > 1
    assert not os.path.exists(os.path.join(path, "metadata.json.tmp"))
    back, meta2 = tckpt.restore(path, tree)
    assert meta2 == meta
    flat = common.canonical_flat(tree)
    for k, v in common.canonical_flat(back).items():
        _equal_bits(v, flat[k], k)
    assert tckpt.latest(str(tmp_path)) == path
    assert tckpt.latest(str(tmp_path / "none")) is None


def test_checkpoints_cross_between_the_packages_bit_exact(tmp_path):
    """A reference checkpoint of the tiny qwen2's parameters restores into
    the port, and the port's restores into the reference, bit for bit; the
    two packages write the same metadata.json for the same tree."""
    _, jp, flat = _reference_params(0)
    tparams = convert.params_from_reference(flat, _port_cfg())
    specs = build_model(_port_cfg()).param_specs()
    jpath = jckpt.save(str(tmp_path / "jax"), jp, step=3)
    tpath = tckpt.save(str(tmp_path / "port"), tparams, step=3)
    with open(os.path.join(jpath, "metadata.json"), "rb") as f:
        jmeta = f.read()
    with open(os.path.join(tpath, "metadata.json"), "rb") as f:
        assert f.read() == jmeta
    with np.load(os.path.join(jpath, "shard_0.npz")) as jz, \
            np.load(os.path.join(tpath, "shard_0.npz")) as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for name in jz.files:
            assert jz[name].dtype == tz[name].dtype, name
            np.testing.assert_array_equal(jz[name], tz[name], err_msg=name)
    into_port, meta = tckpt.restore(jpath, specs)
    assert meta["step"] == 3
    want = common.canonical_flat(tparams)
    for k, v in common.canonical_flat(into_port).items():
        _equal_bits(v, want[k], k)
    into_ref, _ = jckpt.restore(tpath, jp)
    for k, v in j_canonical_flat(into_ref, **IS_ARR).items():
        got, ref = np.asarray(v), flat[k]
        bits = np.uint16 if ref.dtype.itemsize == 2 else np.uint32
        assert got.dtype == ref.dtype, k
        np.testing.assert_array_equal(got.view(bits), ref.view(bits),
                                      err_msg=k)


# --------------------------------------------------------- the DISK tier

def test_register_offload_prefetch_round_trip(tmp_path):
    sm = StateManager(disk_dir=str(tmp_path))
    tree = _tree()
    keys = sm.register("job", tree)
    assert sm.usage()["DEVICE"] == sm.job_bytes("job") > 0
    sm.offload(keys, Tier.HOST)
    assert sm.usage()["DEVICE"] == 0 and sm.usage()["HOST"] > 0
    sm.offload(keys, Tier.DISK)
    assert sm.usage()["HOST"] == 0 and sm.usage()["DISK"] > 0
    files = sorted(os.listdir(tmp_path))
    assert files == sorted(k.replace("/", "__") + ".npy" for k in keys)
    assert all(sm.entries[k].ref is None and sm.entries[k].host is None
               for k in keys)
    # gather reads the spill files and leaves the entries on DISK
    out = sm.gather("job", tree)
    assert sm.usage()["DISK"] == sm.job_bytes("job")
    _equal_bits(out["wb"], tree["wb"])
    assert sm.prefetch(keys) >= 0
    assert sm.usage()["DEVICE"] == sm.job_bytes("job")
    assert not os.listdir(tmp_path)          # spill files read and removed
    flat = common.canonical_flat(tree)
    for k, v in common.canonical_flat(sm.gather("job", tree)).items():
        _equal_bits(v, flat[k], k)
    assert sm.bytes_moved["load"] == sm.job_bytes("job")


def test_bf16_disk_round_trip_is_bit_exact(tmp_path):
    sm = StateManager(disk_dir=str(tmp_path))
    tree = {"w": torch.randn((64, 32), generator=torch.Generator(
        ).manual_seed(1)).bfloat16()}
    keys = sm.register("job", tree)
    sm.offload(keys, Tier.DISK)
    assert sm.entries[keys[0]].is_bf16
    assert np.load(sm.entries[keys[0]].path).dtype == np.uint16
    sm.prefetch(keys)
    _equal_bits(sm.gather("job", tree)["w"], tree["w"])


def test_canonical_dedup_refcount_and_spill_files_unregister(tmp_path):
    sm = StateManager(disk_dir=str(tmp_path))
    tree = _tree()
    k1 = sm.register("job", tree)
    once = sm.usage()["DEVICE"]
    assert sm.register("job", tree) == k1 and sm.usage()["DEVICE"] == once
    sm.offload(k1, Tier.DISK)
    sm.unregister(k1)
    assert sm.usage()["DISK"] == once and len(os.listdir(tmp_path)) == 4
    sm.unregister(k1)
    assert sm.usage() == {"DEVICE": 0, "HOST": 0, "DISK": 0}
    assert not os.listdir(tmp_path)


def test_capacity_eviction_is_lru_device_host_disk(tmp_path):
    """A register or prefetch past ``device_capacity`` sends the least
    recently touched DEVICE entries to HOST; past ``host_capacity`` the
    least recently touched HOST entries go on to DISK."""
    sm = StateManager(disk_dir=str(tmp_path), device_capacity=9000,
                      host_capacity=5000)

    def reg(name, value):
        return sm.register("job", {name: torch.full((1024,), value)},
                           prefix="x")[0]

    def tiers():
        return {k[-1]: e.tier.name for k, e in sm.entries.items()}

    a, b = reg("a", 1.0), reg("b", 2.0)
    assert sm.usage() == {"DEVICE": 8192, "HOST": 0, "DISK": 0}
    reg("c", 3.0)
    assert tiers() == {"a": "HOST", "b": "DEVICE", "c": "DEVICE"}
    reg("d", 4.0)                       # b to HOST, then a on to DISK
    assert tiers() == {"a": "DISK", "b": "HOST", "c": "DEVICE",
                       "d": "DEVICE"}
    sm.prefetch([a])                    # c to HOST, then b on to DISK
    assert tiers() == {"a": "DEVICE", "b": "DISK", "c": "HOST",
                       "d": "DEVICE"}
    assert sorted(os.listdir(tmp_path)) == [b.replace("/", "__") + ".npy"]
    out = sm.gather("job", {n: 0 for n in "abcd"}, prefix="x")
    for i, n in enumerate("abcd"):
        assert bool((out[n] == i + 1).all()), n


def test_migrate_lands_disk_entries_on_host_like_jax(tmp_path):
    """A job with one entry on each tier migrates whole: the DISK entry is
    read before the source drops its spill file and lands on HOST, as in
    the reference's ``migrate``; after a prefetch on the destination every
    leaf is bit-exact and equals what the JAX StateManager hands over."""
    from repro.core.state_manager import StateManager as JStateManager
    from repro.core.state_manager import Tier as JTier
    import jax.numpy as jnp

    tree = _tree()
    jtree = {"w1": jnp.asarray(tree["w1"].numpy()),
             "wb": jnp.asarray(tree["wb"].float().numpy(), jnp.bfloat16),
             "nested": {"w2": jnp.asarray(tree["nested"]["w2"].numpy()),
                        "step": jnp.asarray(tree["nested"]["step"].numpy())}}
    tiers = {}
    for name, sm_cls, tier, t in (("port", StateManager, Tier, tree),
                                  ("jax", JStateManager, JTier, jtree)):
        src = sm_cls(node_id="src", disk_dir=str(tmp_path / name / "a"))
        dst = sm_cls(node_id="dst", disk_dir=str(tmp_path / name / "b"))
        src.register("job", t)
        src.offload(["job/params/w1"], tier.HOST)
        src.offload(["job/params/wb"], tier.DISK)
        assert src.migrate("job", dst) == src.last_migrate["bytes"] > 0
        assert not src.entries and not os.listdir(tmp_path / name / "a")
        tiers[name] = {k: e.tier.name for k, e in dst.entries.items()}
        dst.prefetch(list(dst.entries))
        tiers[name + " after prefetch"] = {k: e.tier.name
                                           for k, e in dst.entries.items()}
        if name == "port":
            out = common.canonical_flat(dst.gather("job", tree))
            for k, v in common.canonical_flat(tree).items():
                _equal_bits(out[k], v, k)
        else:
            jout = j_canonical_flat(dst.gather("job", jtree))
    assert tiers["port"]["job/params/wb"] == tiers["jax"]["job/params/wb"] \
        == "HOST"
    assert tiers["port after prefetch"] == tiers["jax after prefetch"]
    for k, v in out.items():
        np.testing.assert_array_equal(
            v.float().numpy(), np.asarray(jout[k], np.float32), err_msg=k)


@pytest.mark.parametrize("tier", [Tier.HOST, Tier.DISK])
def test_materialize_checkpoint_from_offloaded_state(tmp_path, tier):
    sm = StateManager(node_id="g7", disk_dir=str(tmp_path / "disk"))
    tree = _tree()
    keys = sm.register("job", tree)
    sm.offload(keys, tier)
    path = sm.materialize_checkpoint("job", tree, str(tmp_path / "ckpt"),
                                     step=4)
    assert all(sm.entries[k].tier == tier for k in keys)
    back, meta = tckpt.restore(path, tree)
    assert meta["job_id"] == "job" and meta["node"] == "g7" \
        and meta["step"] == 4
    flat = common.canonical_flat(tree)
    for k, v in common.canonical_flat(back).items():
        _equal_bits(v, flat[k], k)


# ------------------------------------------------------ through the system

def _job(job_id, seed, steps=1):
    return JobConfig(job_id=job_id, model_name="qwen2-0.5b", steps=steps,
                     batch_size=4, group_size=2, max_new_tokens=4,
                     seq_len=24, overrides=OVERRIDES, seed=seed)


def test_checkpoint_all_fail_node_restore_all(tmp_path):
    """tests/test_system.py's flow: a job trains a step, every deployment
    is checkpointed, the node fails (its DEVICE state is lost), and
    restore_all brings the parameters back bit for bit. A restore into a
    deployment that still holds its parameters writes into them."""
    c = PlexCluster(n_groups=1, device_plane=DevicePlane(devices=[CPU]))
    c.add_job(_job("jobC", 3))
    c.run()
    wpg = c.router.wpgs["jobC-train"]
    paths = c.checkpoint_all(str(tmp_path))
    assert paths == {"jobC-train": str(tmp_path / "jobC-train")}
    before = {k: v.clone() for k, v in
              common.canonical_flat(wpg.params()).items()}
    lost = c.fail_node(0)
    assert lost and not c.router.state_managers[0].keys_for(
        wpg.job_prefix, "params")
    c.restore_all(paths)
    after = common.canonical_flat(wpg.params())
    assert after.keys() == before.keys()
    for k, v in after.items():
        _equal_bits(v, before[k], k)
    refs = {k: v.data_ptr() for k, v in after.items()}
    for v in after.values():
        v.zero_()
    c.restore_all(paths)
    for k, v in common.canonical_flat(wpg.params()).items():
        assert v.data_ptr() == refs[k], k
        _equal_bits(v, before[k], k)


def test_save_and_load_checkpoint_ops_through_the_router(tmp_path):
    c = PlexCluster(n_groups=1, device_plane=DevicePlane(devices=[CPU]))
    ctl = c.add_job(_job("jobS", 4))
    c.run()
    dep = ctl.dep
    saved = dep.save_checkpoint(str(tmp_path / "s"), 9)
    c.router.drain()
    assert saved.result() == str(tmp_path / "s")
    other = c.router.deploy(api.DeploymentSpec(
        deployment_id="jobS-roll", job_id="jobS", model_name="qwen2-0.5b",
        role="rollout", overrides=OVERRIDES))
    loaded = other.load_checkpoint(str(tmp_path / "s"))
    c.router.drain()
    assert loaded.result()["step"] == 9
    want = common.canonical_flat(dep.wpg.params())
    for k, v in common.canonical_flat(other.wpg.params()).items():
        _equal_bits(v, want[k], k)
        assert v.data_ptr() != want[k].data_ptr()


def test_launch_train_checkpoints_after_the_run(tmp_path, capsys):
    from repro_torch.launch import train
    ckpt_dir = str(tmp_path / "ck")
    train.main(["--device", "cpu", "--jobs", "2", "--steps", "1",
                "--layers", "2", "--d-model", "64", "--vocab", "128",
                "--batch-size", "4", "--group-size", "2",
                "--max-new-tokens", "4", "--seq-len", "16",
                "--ckpt-dir", ckpt_dir])
    out = capsys.readouterr().out
    assert out.index("wall=") < out.index("checkpoints:")
    paths = json.loads(out[out.index("checkpoints:") + len("checkpoints:"):])
    assert sorted(paths) == ["job0-train", "job1-train"]
    specs = build_model(_port_cfg().replace(
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=64, d_ff=256)
    ).param_specs()
    for path in paths.values():
        tree, meta = tckpt.restore(path, specs)
        assert all(bool(torch.isfinite(v.float()).all())
                   for v in common.canonical_flat(tree).values())
