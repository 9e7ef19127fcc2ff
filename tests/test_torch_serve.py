"""The port's serving path, held against the JAX package on the CPU.

Two jobs' rollout deployments share node group 0 of each package's Router.
The JAX deployments are initialised from seeds; their parameters are
carried to the port by ``models/convert.py``, so both routers serve from
identical weights. Greedy generation is compared token by token along each
row while the two sides agree: a disagreement is accepted only where the
JAX model's top-2 logit margin at that step is within the bf16 logit
tolerance of tests/test_torch_model.py (2^-6 * max |logit|), i.e. where
the two packages' bf16 roundings may legitimately break a near-tie; the
rest of that row is then skipped, because the contexts differ from there.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core.router import Router as JRouter
from repro.models.common import canonical_flat as j_canonical_flat
from repro_torch.core import api
from repro_torch.core.router import Router
from repro_torch.launch.mesh import DevicePlane
from repro_torch.models import convert
from repro_torch.rl import data as data_lib

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# qwen2-0.5b cut to two narrow layers, keeping its GQA group of g = 7,
# QKV bias, tied embeddings and RoPE theta
OVERRIDES = (("num_layers", 2), ("d_model", 64), ("num_heads", 14),
             ("num_kv_heads", 2), ("head_dim", 16), ("d_ff", 128),
             ("vocab_size", 128))
ORDER = ("A", "B", "A")       # alternating jobs: every round switches
N_NEW = 6


def _spec(mod, job):
    return mod.DeploymentSpec(deployment_id=f"roll-{job}", job_id=job,
                              model_name="qwen2-0.5b", role="rollout",
                              overrides=OVERRIDES)


def _prompts():
    prompts, _ = next(data_lib.MathDataset(seed=0).batches(3, 10))
    return np.asarray(prompts, np.int32) % 128


def _jax_serve(prompts):
    router = JRouter()
    deps = {job: router.deploy(_spec(japi, job), group_id=0) for job in "AB"}
    for seed, dep in enumerate(deps.values()):
        dep.init(seed=seed)
    router.drain()
    flat = {job: {k: np.asarray(v) for k, v in j_canonical_flat(
        dep.wpg.params(), is_leaf=lambda x: hasattr(x, "shape")).items()}
        for job, dep in deps.items()}
    outs = []
    for job in ORDER:
        fut = deps[job].generate(jnp.asarray(prompts), max_new_tokens=N_NEW,
                                 temperature=0.0)
        router.drain()
        outs.append(np.asarray(fut.wait()["tokens"]))
    return router, deps, flat, outs


def _margins(wpg, prompts, toks):
    """JAX top-2 logit margin for each generated token (teacher-forced)."""
    seq = jnp.asarray(np.concatenate([prompts, toks[:, :-1]], 1))
    logits = np.asarray(wpg.model.forward(wpg.params(), {"tokens": seq})[0],
                        np.float32)[:, prompts.shape[1] - 1:]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0], 2.0 ** -6 * np.abs(logits).max()


def test_port_router_serves_like_jax_router_on_two_jobs():
    prompts = _prompts()
    jrouter, jdeps, flat, jouts = _jax_serve(prompts)

    router = Router(device_plane=DevicePlane(devices=[torch.device("cpu")]))
    deps = {job: router.deploy(_spec(api, job), group_id=0) for job in "AB"}
    with router:
        for job, dep in deps.items():
            params = convert.params_from_reference(flat[job],
                                                   dep.wpg.cfg)
            dep.call(api.Op.INIT, params=params).wait(timeout=60)
        outs = [deps[job].generate(prompts, max_new_tokens=N_NEW,
                                   temperature=0.0).wait(timeout=120)
                for job in ORDER]

    held = 0
    for job, jtok, out in zip(ORDER, jouts, outs):
        ttok = out["tokens"].numpy()
        assert ttok.shape == jtok.shape == (prompts.shape[0], N_NEW)
        assert np.isfinite(out["logprobs"].numpy()).all()
        margin, tol = _margins(jdeps[job].wpg, prompts, jtok)
        for b in range(ttok.shape[0]):
            for i in range(N_NEW):
                if ttok[b, i] != jtok[b, i]:
                    assert margin[b, i] <= tol, (job, b, i, margin[b, i], tol)
                    break
                held += margin[b, i] > tol
    # the comparison must have bitten: most steps are not near-ties
    assert held >= len(ORDER) * prompts.shape[0] * N_NEW // 2, held
    # every round switched jobs on the shared group, in both packages
    assert len(router.switch_log) >= len(ORDER)
    assert [s["to_job"] for s in router.switch_log[-len(ORDER):]] == \
        list(ORDER)
    assert len(jrouter.switch_log) >= len(ORDER)
    for s in router.switch_log:
        assert s["t_offload"] >= 0 and s["t_load"] >= 0


def test_serial_and_bounded_drivers_match_serve_mode():
    """step/drain and run_until_idle admit and execute on the same path as
    serve(): greedy generation gives the same tokens under each driver."""
    prompts = _prompts()
    tokens = []
    for driver in ("serve", "drain", "run_until_idle"):
        router = Router(device_plane=DevicePlane(
            devices=[torch.device("cpu")]))
        deps = {job: router.deploy(_spec(api, job), group_id=0)
                for job in "AB"}
        futs = [dep.init(seed=i) for i, dep in enumerate(deps.values())]
        futs += [deps[job].generate(prompts, max_new_tokens=3,
                                    temperature=0.0) for job in ORDER]
        if driver == "serve":
            with router:
                assert router.wait_idle(timeout=120)
        elif driver == "drain":
            assert router.drain() == len(futs)
        else:
            assert router.run_until_idle(timeout=120) == len(futs)
        tokens.append([f.wait(timeout=1)["tokens"] for f in futs[2:]])
        assert [s["to_job"] for s in router.switch_log] == list(ORDER)
    for other in tokens[1:]:
        for a, b in zip(tokens[0], other):
            assert torch.equal(a, b)


def test_rollout_greedy_flag_samples_greedily():
    """``RolloutConfig(greedy=True)`` takes the argmax at any temperature,
    as the reference's (``repro/rl/rollout.py:57``), and draws nothing from
    the generator; at temperature 0 it is the same rollout."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.rl.rollout import RolloutConfig, rollout

    cfg = get_config("qwen2-0.5b").replace(**dict(OVERRIDES))
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    # the seeded init's unit-scale tied embedding makes the policy one-hot
    # (tests/test_torch_train.py); scaled by 1/16 a sample can differ
    params["embed"]["embedding"].mul_(1 / 16)
    prompts = torch.as_tensor(_prompts(), dtype=torch.long)
    runs = []
    for rc in (RolloutConfig(max_new_tokens=5, temperature=1.5, greedy=True),
               RolloutConfig(max_new_tokens=5, temperature=0.0)):
        gen = torch.Generator().manual_seed(1)
        state = gen.get_state()
        runs.append(rollout(model, params, prompts, gen, rc))
        assert torch.equal(gen.get_state(), state)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    # the first token is the argmax of the prefill's last logits
    logits = model.forward(params, {"tokens": prompts})[0][:, -1]
    assert torch.equal(runs[0][0][:, 0], logits.argmax(-1))
    sampled = rollout(model, params, prompts, torch.Generator().manual_seed(1),
                      RolloutConfig(max_new_tokens=5, temperature=1.5))
    assert not torch.equal(sampled[0], runs[0][0])


def test_state_manager_moves_and_times_state_between_tiers():
    from repro_torch.core.state_manager import StateManager, Tier

    ticks = iter(range(100))
    sm = StateManager(clock=lambda: float(next(ticks)))
    tree = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "b": torch.ones(4)}
    keys = sm.register("job", tree)
    assert sm.register("job", tree) == keys          # dedup: refcount 2
    assert sm.job_bytes("job") == 6 * 2 + 4 * 4
    assert sm.offload(keys) == 1.0                   # one tick of the clock
    assert {sm.entries[k].tier for k in keys} == {Tier.HOST}
    assert sm.offload_time_estimate(sm.job_bytes("job")) == 1.0
    assert sm.prefetch(keys) == 1.0
    assert {sm.entries[k].tier for k in keys} == {Tier.DEVICE}
    back = sm.gather("job", tree)
    assert torch.equal(back["w"], tree["w"]) and torch.equal(back["b"],
                                                             tree["b"])
    sm.unregister(keys)
    assert sm.keys_for("job") == keys
    sm.unregister(keys)
    assert sm.keys_for("job") == []


def test_device_plane_leases_lowest_free_then_least_loaded():
    plane = DevicePlane(devices=["cpu", "cpu"])
    assert [plane.slice_for_group(g).index for g in (5, 6, 7, 8, 5)] == \
        [0, 1, 0, 1, 0]
    assert plane.slice_for_group(7).device == torch.device("cpu")


def test_unported_ops_raise_naming_the_roadmap(tmp_path):
    """Every op of the service API runs on the port now (the PPO readouts,
    the host optimizer step, the checkpoint ops, a weight sync into target
    shardings, here a 2-device layout written back into the one-device
    target bit-exact), and a process-mode group of several devices
    spawns its child on its slice; the production meshes, ported, are
    built (512 ``meta`` devices), and what stays unported,
    ``mesh_bench.py``, is the one part left in ``PARTS``."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import common
    from repro_torch.models import sharding as shd

    router = Router(device_plane=DevicePlane(devices=[torch.device("cpu")]))
    dep = router.deploy(_spec(api, "A"), group_id=0)
    other = router.deploy(_spec(api, "B"), group_id=0)
    dep.init(seed=0)
    other.init(seed=1)
    batch = {"tokens": np.arange(24, dtype=np.int32).reshape(2, 12) % 100}
    path = str(tmp_path / "ckpt")
    ran = [dep.forward(batch, output="values"), dep.save_checkpoint(path, 3),
           dep.load_checkpoint(path)]
    model = dep.wpg.model
    mesh = make_local_mesh(1, 2, devices=[torch.device("cpu")] * 2)
    fut = dep.sync_weights(other, target_shardings=shd.tree_shardings(
        model.logical_axes(), mesh, shd.named_rules("tp"),
        model.param_specs()))
    router.drain()
    values, saved, meta = (f.result() for f in ran)
    assert tuple(values.shape) == (2, 12) and bool(values.abs().le(1).all())
    assert saved == path and meta["step"] == 3
    assert fut.result()["synced_bytes"] > 0
    got = common.canonical_flat(other.wpg.params())
    for k, v in common.canonical_flat(dep.wpg.params()).items():
        assert torch.equal(got[k], v), k
    proc = Router(device_plane=DevicePlane(devices=["cpu", "cpu"],
                                           slice_size=2), process_plane=True)
    try:
        assert proc.ensure_group(0).mesh_slice.n_devices == 2
        assert proc.group_procs[0].devices == ["cpu", "cpu"]
    finally:
        proc.close_processes()
    from repro_torch.launch.mesh import make_production_mesh
    assert make_production_mesh(multi_pod=True).size == 512
    assert set(shd.PARTS) == {6} and "mesh_bench.py" in shd.PARTS[6]


def test_port_imports_and_serves_without_jax_or_reference_package():
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        "import importlib, pkgutil, torch",
        "torch.set_num_threads(1)",
        "import repro_torch",
        "names = [m.name for m in pkgutil.walk_packages(",
        "    repro_torch.__path__, 'repro_torch.')]",
        "for name in names:",
        "    importlib.import_module(name)",
        "print('imported', len(names))",
        "from repro_torch.launch import serve",
        "serve.main(['--device', 'cpu', '--batch', '2', '--prompt-len', '8',",
        "            '--max-new', '4', '--layers', '2', '--d-model', '128',",
        "            '--rounds', '2'])",
        "serve.main(['--device', 'cpu', '--arch', 'mamba2-2.7b', '--batch',",
        "            '2', '--prompt-len', '8', '--max-new', '4', '--layers',",
        "            '2', '--d-model', '128', '--rounds', '2'])",
        "serve.main(['--device', 'cpu', '--arch', 'zamba2-7b', '--batch',",
        "            '2', '--prompt-len', '8', '--max-new', '4', '--layers',",
        "            '2', '--d-model', '128', '--rounds', '2'])",
        "serve.main(['--device', 'cpu', '--arch', 'granite-moe-3b-a800m',",
        "            '--batch', '2', '--prompt-len', '8', '--max-new', '4',",
        "            '--layers', '2', '--d-model', '128', '--rounds', '2'])",
        "serve.main(['--device', 'cpu', '--arch', 'gemma2-27b', '--batch',",
        "            '2', '--prompt-len', '8', '--max-new', '4', '--layers',",
        "            '2', '--d-model', '128', '--rounds', '2'])",
        "assert 'repro_torch.models.hybrid' in names, names",
        "assert 'repro_torch.models.moe' in names, names",
        "assert 'repro_torch.models.vision' in names, names",
    ])
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "imported" in proc.stdout
    assert proc.stdout.count("round ") == 10, proc.stdout


def test_port_trains_two_grpo_jobs_without_jax_or_reference_package():
    """Every module imports with ``jax`` and ``repro`` blocked; two GRPO
    jobs then take two interleaved steps each on one CPU group of a
    ``PlexCluster``, which bills both steps, and the context switches move
    each job's AdamW state with its parameters."""
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        "import importlib, math, pkgutil, torch",
        "torch.set_num_threads(1)",
        "import repro_torch",
        "for m in pkgutil.walk_packages(repro_torch.__path__,",
        "                               'repro_torch.'):",
        "    importlib.import_module(m.name)",
        "from repro_torch.core.cluster import PlexCluster",
        "from repro_torch.core.controller import JobConfig",
        "from repro_torch.launch.mesh import DevicePlane",
        f"tiny = {OVERRIDES!r}",
        "cluster = PlexCluster(device_plane=DevicePlane(devices=['cpu']))",
        "router = cluster.router",
        "ctls = [cluster.add_job(JobConfig(",
        "    job_id=j, model_name='qwen2-0.5b', batch_size=4, group_size=2,",
        "    prompt_len=12, max_new_tokens=4, seq_len=16, steps=2, seed=s,",
        "    overrides=tiny))",
        "    for s, j in enumerate('AB', 1)]",
        "billing = cluster.run(interleave=True)",
        "sm = router.state_managers[0]",
        "for c in ctls:",
        "    assert billing[c.cfg.job_id].steps == 2",
        "    pre = c.dep.wpg.job_prefix",
        "    assert len(c.metrics_log) == 2, c.metrics_log",
        "    assert all(math.isfinite(m['loss']) for m in c.metrics_log)",
        "    opt = sum(sm.entries[k].nbytes for k in sm.keys_for(pre, 'opt'))",
        "    assert opt > 2 * sum(sm.entries[k].nbytes",
        "                         for k in sm.keys_for(pre, 'params'))",
        "    moved = [s for s in router.switch_log",
        "             if s['to_job'] != c.cfg.job_id and s['t_offload'] > 0]",
        "    assert moved and all(s['offload_bytes'] == sm.job_bytes(pre)",
        "                         for s in moved), (moved, sm.job_bytes(pre))",
        "print('switches', len(router.switch_log))",
    ])
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "switches" in proc.stdout
