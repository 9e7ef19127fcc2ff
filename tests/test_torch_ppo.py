"""The port's PPO job (an actor and a critic deployment) and the
StateManager's host optimizer step, held against the JAX package on the
CPU.

Inputs are drawn from numpy seeds and fed to both packages; the model is
tests/test_torch_train.py's qwen2-0.5b cut to two narrow layers, its
parameters the JAX package's seeded init (tied embedding scaled by 1/16)
carried across by ``models/convert.py``. Tolerances as there: f32 2e-3
(1e-5 relative where both sides do the same f32 arithmetic: GAE, the value
loss, the optimizers), bf16 quantities 5e-2 relative to the largest
magnitude of the leaf or metric. ``bk``'s gradient is 0 in exact
arithmetic (a key bias shifts each query's scores by a constant), so its
sign and size are rounding noise and it is left out where gradients or
update directions are compared.
"""
import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core.controller import JobConfig as JJobConfig
from repro.core.controller import RLControllerPPO as JRLControllerPPO
from repro.core.router import Router as JRouter
from repro.core.state_manager import StateManager as JStateManager
from repro.core.worker import WorkerProcessGroup as JWPG
from repro.core.worker import _value_readout as j_value_readout
from repro.models.common import canonical_flat as j_canonical_flat
from repro.rl import ppo as jppo
from repro.train import optimizer as jopt
from repro_torch.core import api
from repro_torch.core.cluster import PlexCluster
from repro_torch.core.controller import JobConfig, RLControllerPPO
from repro_torch.core.state_manager import StateManager, Tier
from repro_torch.core.worker import WorkerProcessGroup, _value_readout
from repro_torch.launch.mesh import DevicePlane
from repro_torch.models import common, convert
from repro_torch.rl import ppo as tppo
from repro_torch.train import optimizer as topt
from test_torch_train import (BF16_REL, FAST_LR, IS_ARR, OVERRIDES,
                              _close_rel, _cpu_router, _fake_generate,
                              _jbatch, _loss_inputs, _n, _reference_params,
                              _seeded_batch, _t, _two_steps, _wpg_pair)

torch.set_num_threads(1)

SKIP = "layers/attn/bk"


def _ppo_batch(seed, token_adv=True):
    """``_seeded_batch`` with PPO's token-level advantages and a critic's
    value targets and old values (numpy)."""
    batch = _seeded_batch(seed)
    rng = np.random.default_rng(seed + 100)
    b, s = batch["tokens"].shape
    if token_adv:
        batch["advantages"] = rng.standard_normal((b, s)).astype(np.float32)
    batch["old_values"] = np.tanh(rng.standard_normal((b, s))).astype(
        np.float32)
    batch["value_targets"] = (batch["old_values"] + 0.5 * rng.standard_normal(
        (b, s))).astype(np.float32)
    return batch


# ------------------------------------------------------------- the losses

@pytest.mark.parametrize("gamma,lam", [(1.0, 0.95), (0.9, 0.8)])
def test_gae_advantages_match_jax(gamma, lam):
    rng = np.random.default_rng(1)
    b, t = 4, 13
    rewards = np.zeros((b, t), np.float32)
    rewards[np.arange(b), rng.integers(5, t, b)] = rng.standard_normal(b)
    values = rng.standard_normal((b, t)).astype(np.float32)
    mask = (rng.uniform(size=(b, t)) > 0.2).astype(np.float32)
    cfg_j = jppo.PPOConfig(gamma=gamma, gae_lambda=lam)
    cfg_t = tppo.PPOConfig(gamma=gamma, gae_lambda=lam)
    jadv = jppo.gae_advantages(jnp.asarray(rewards), jnp.asarray(values),
                               jnp.asarray(mask), cfg_j)
    tadv = tppo.gae_advantages(torch.from_numpy(rewards),
                               torch.from_numpy(values),
                               torch.from_numpy(mask), cfg_t)
    assert tadv.shape == (b, t) and tadv.dtype == torch.float32
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_value_readout_matches_jax(dtype):
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((3, 7, 50)) * 5).astype(np.float32)
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    jv, tv = j_value_readout(jl), _value_readout(tl)
    assert tv.shape == (3, 7) and tv.dtype == torch.float32
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)


def test_value_loss_matches_jax():
    batch = _ppo_batch(3)
    values = np.tanh(np.random.default_rng(4).standard_normal(
        batch["old_values"].shape)).astype(np.float32)
    args = (values, batch["value_targets"], batch["old_values"],
            batch["loss_mask"])
    jvl = jppo.value_loss(*map(jnp.asarray, args), jppo.PPOConfig())
    tvl = tppo.value_loss(*map(torch.from_numpy, args), tppo.PPOConfig())
    np.testing.assert_allclose(float(tvl), float(jvl), rtol=1e-5)
    assert float(tvl) > 0


@pytest.mark.parametrize("token_adv,entropy_coef", [(True, 0.0),
                                                    (False, 0.01)])
def test_ppo_loss_matches_jax(token_adv, entropy_coef):
    jm, jp, tm, params, _ = _loss_inputs()
    batch = _ppo_batch(3, token_adv)
    jloss, jmet = jppo.ppo_loss(jp, jm, _jbatch(batch),
                                jppo.PPOConfig(entropy_coef=entropy_coef))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["tokens"] = tb["tokens"].long()
    tloss, tmet = tppo.ppo_loss(params, tm, tb,
                                tppo.PPOConfig(entropy_coef=entropy_coef))
    assert tmet.keys() == jmet.keys() == {"pg_loss"}
    _close_rel(tloss, jloss, what="loss")
    _close_rel(tmet["pg_loss"], jmet["pg_loss"], what="pg_loss")
    assert abs(float(tmet["pg_loss"])) > 1e-3


# ----------------------------------------------------------------- the WPG

def _grads_close(tgrads, jgrads):
    jflat = j_canonical_flat(jgrads, **IS_ARR)
    tflat = common.canonical_flat(tgrads)
    assert jflat.keys() == tflat.keys()
    for k, g in tflat.items():
        if k == SKIP:
            continue
        assert float(np.abs(_n(jflat[k])).max()) > 0, k
        _close_rel(g, jflat[k], what=k)


def test_wpg_values_ppo_and_value_ops_match_jax_wpg():
    """FORWARD(output="values"), FORWARD_BACKWARD(objective="ppo") and
    (objective="value") against the JAX WPG from the same parameters."""
    jw, tw, _ = _wpg_pair()
    batch = _ppo_batch(5)
    jv = jw.execute(japi.make_op(jw.spec, japi.Op.FORWARD, _jbatch(batch),
                                 output="values"))
    tv = tw.execute(api.make_op(tw.spec, api.Op.FORWARD, batch,
                                output="values"))
    assert tv.shape == batch["tokens"].shape and tv.dtype == torch.float32
    _close_rel(tv, jv, what="values")
    for objective, metric in (("ppo", "pg_loss"), ("value", "value_loss")):
        jfb = jw.execute(japi.make_op(jw.spec, japi.Op.FORWARD_BACKWARD,
                                      _jbatch(batch), objective=objective))
        tfb = tw.execute(api.make_op(tw.spec, api.Op.FORWARD_BACKWARD,
                                     batch, objective=objective))
        assert tfb["metrics"].keys() == jfb["metrics"].keys() == {
            "loss", metric}
        for k in jfb["metrics"]:
            _close_rel(tfb["metrics"][k], jfb["metrics"][k], what=k)
        _grads_close(tfb["grads"], jfb["grads"])
    assert [op for op, _ in tw.exec_log] == [
        "init", "forward", "forward_backward", "forward_backward"]
    with pytest.raises(ValueError, match="objective"):
        tw.execute(api.make_op(tw.spec, api.Op.FORWARD_BACKWARD, batch,
                               objective="dpo"))


# ------------------------------------------------- the host optimizer step

def _host_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w1": rng.standard_normal((8, 16)).astype(np.float32),
            "nested": {"w2": rng.standard_normal(4).astype(np.float32),
                       "wb": rng.standard_normal((3, 5)).astype(np.float32)}}


def _tree_to(tree, jax_side, bf16=("wb",)):
    def leaf(k, v):
        if jax_side:
            a = jnp.asarray(v)
            return a.astype(jnp.bfloat16) if k in bf16 else a
        t = torch.from_numpy(v.copy())
        return t.bfloat16() if k in bf16 else t
    return {k: ({kk: leaf(kk, vv) for kk, vv in v.items()}
                if isinstance(v, dict) else leaf(k, v))
            for k, v in tree.items()}


@pytest.mark.parametrize("moments", ["created on HOST", "on DEVICE"])
def test_host_optimizer_step_matches_jax_state_manager(moments):
    """Two host steps on the same state and gradients in both packages:
    parameters (f32 and bf16 leaves), both moments and the step count.
    Moments the device optimizer made (``opt`` entries on DEVICE) are
    updated where they are, as the reference updates them."""
    params = _host_tree(0)
    jsm, tsm = JStateManager(), StateManager()
    jsm.register("job", _tree_to(params, True))
    tsm.register("job", _tree_to(params, False))
    if moments == "on DEVICE":
        jsm.register("job", jopt.init(_tree_to(params, True)), prefix="opt")
        tsm.register("job", topt.init(_tree_to(params, False))._asdict(),
                     prefix="opt")
    for i in range(2):
        grads = _host_tree(10 + i)
        js = jsm.host_optimizer_step("job", _tree_to(grads, True), None,
                                     lr=1e-2)
        ts = tsm.host_optimizer_step("job", _tree_to(grads, False), None,
                                     lr=1e-2)
        assert ts == js == i + 1
    assert set(tsm.entries) == set(jsm.entries)
    for k, e in tsm.entries.items():
        want = np.asarray(jnp.asarray(jsm.entries[k].ref, jnp.float32))
        got = e.ref.float().numpy()
        if k == "job/params/nested/wb":          # the bf16 parameter
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        if "/params/" in k:
            assert e.tier == Tier.HOST, k        # pulled to the host
        elif moments == "created on HOST":
            assert e.tier == Tier.HOST, k
    assert int(tsm.entries["job/opt/step"].ref) == 2


def test_host_optimizer_step_matches_device_adamw():
    """The CPU step equals the device AdamW with no clip, warmup or weight
    decay (as tests/test_state_manager.py configures it)."""
    params = _tree_to(_host_tree(1), False, bf16=())
    grads = common.tree_map(lambda p: torch.full_like(p, 0.1), params,
                            is_leaf=torch.is_tensor)
    sm = StateManager()
    sm.register("job", common.tree_map(torch.clone, params,
                                       is_leaf=torch.is_tensor))
    sm.host_optimizer_step("job", grads, None, lr=1e-2)
    cfg = topt.AdamWConfig(lr=1e-2, grad_clip=0.0, warmup_steps=0,
                           weight_decay=0.0)
    dev = common.tree_map(torch.clone, params, is_leaf=torch.is_tensor)
    topt.update_(grads, topt.init(dev, cfg), dev, cfg)
    host = common.canonical_flat(sm.gather("job", params))
    for k, v in common.canonical_flat(dev).items():
        np.testing.assert_allclose(host[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_optim_step_on_the_host_through_the_wpg():
    """OPTIM_STEP(host=True) on a train deployment: the parameters go to
    the host and move, the device optimizer's moments and step advance in
    place, and a prefetch brings the parameters back."""
    _, tw, _ = _wpg_pair()
    fb = tw.execute(api.make_op(tw.spec, api.Op.FORWARD_BACKWARD,
                                _seeded_batch(5)))
    sm, pre = tw.sm, tw.job_prefix
    before = {k: sm.entries[k].ref.clone() for k in sm.keys_for(pre)}
    mu_ref = {k: sm.entries[k].ref for k in sm.keys_for(pre, "opt")}
    out = tw.execute(api.make_op(tw.spec, api.Op.OPTIM_STEP, fb["grads"],
                                 host=True))
    assert out == {"step": 1, "host": True}
    assert all(sm.entries[k].tier == Tier.HOST
               for k in sm.keys_for(pre, "params"))
    assert not tw.resident()
    assert all(sm.entries[k].ref is r for k, r in mu_ref.items())
    moved = [k for k in sm.keys_for(pre, "params")
             if not torch.equal(sm.entries[k].ref, before[k])]
    assert len(moved) > 0.8 * len(sm.keys_for(pre, "params"))
    tw.ensure_resident()
    assert tw.resident()


# ------------------------------------------------------ the controller

def test_ppo_controller_two_steps_match_jax(monkeypatch):
    """Two RLControllerPPO steps (generate patched to the same seeded
    completions in both packages) from the same actor and critic
    parameters: rewards, every step's metrics, and the actor's and the
    critic's parameters after the steps."""
    monkeypatch.setattr(JWPG, "_op_generate", _fake_generate)
    monkeypatch.setattr(WorkerProcessGroup, "_op_generate", _fake_generate)
    kw = dict(job_id="P", model_name="qwen2-0.5b", batch_size=8,
              group_size=4, prompt_len=40, max_new_tokens=24, seq_len=64,
              steps=2, seed=7, overrides=OVERRIDES)
    _, jp0, flat0 = _reference_params(7)
    jrouter = JRouter(wpg_factory=functools.partial(
        JWPG, adamw_cfg=jopt.AdamWConfig(**FAST_LR)))
    jctl = JRLControllerPPO(JJobConfig(**kw), jrouter)
    jctl.submit_init()
    jrouter.drain()
    for dep in (jctl.dep, jctl.critic):
        dep.wpg._store(params=jp0)
    router = _cpu_router(wpg_factory=functools.partial(
        WorkerProcessGroup, adamw_cfg=topt.AdamWConfig(**FAST_LR)))
    ctl = RLControllerPPO(JobConfig(**kw), router)
    for dep in (ctl.dep, ctl.critic):
        dep.call(api.Op.INIT, params=convert.params_from_reference(
            flat0, dep.wpg.cfg))
    router.drain()
    _two_steps(jctl, jrouter)
    _two_steps(ctl, router)
    assert ctl.reward_log == jctl.reward_log == [0.5, 0.5]
    assert len(ctl.metrics_log) == len(jctl.metrics_log) == 2
    for tm, jm in zip(ctl.metrics_log, jctl.metrics_log):
        assert tm.keys() == jm.keys() >= {"pg_loss", "value_loss", "step",
                                          "grad_norm", "loss"}
        for k in jm:
            _close_rel(tm[k], jm[k], what=k)
    assert [m["step"] for m in ctl.metrics_log] == [1, 2]
    ops_run = [op for op, _ in ctl.critic.wpg.exec_log]
    assert ops_run == ["init"] + ["forward", "forward_backward",
                                  "optim_step"] * 2
    for dep, jdep in ((ctl.dep, jctl.dep), (ctl.critic, jctl.critic)):
        jflat = j_canonical_flat(jdep.wpg.params(), **IS_ARR)
        moved = agree = 0
        for k, v in common.canonical_flat(dep.wpg.params()).items():
            if k == SKIP:
                continue
            p0, tp, jp = _n(_t(flat0[k])), _n(v), _n(jflat[k])
            dt, dj = tp - p0, jp - p0
            moved += int((dj != 0).sum())
            agree += int(((dj != 0) & (np.sign(dt) == np.sign(dj))).sum())
        assert moved > 0 and agree >= 0.97 * moved, (dep, agree, moved)
    # the critic is the synced actor plus one value step: not the actor
    actor = common.canonical_flat(ctl.dep.wpg.params())
    critic = common.canonical_flat(ctl.critic.wpg.params())
    assert any(not torch.equal(actor[k], critic[k]) for k in actor)
    assert all(actor[k].data_ptr() != critic[k].data_ptr() for k in actor)


def _tiny_job(job_id, seed, steps=2):
    return JobConfig(job_id=job_id, model_name="qwen2-0.5b", steps=steps,
                     batch_size=4, group_size=2, max_new_tokens=4,
                     seq_len=24, overrides=OVERRIDES, seed=seed)


def test_serve_grpo_then_ppo_attach_complete_and_bill():
    """tests/test_serve_api.py's acceptance flow on the port: a GRPO job
    starts under a live serve() plane; a PPO job attaches after serving
    began, on a new group (spawning its dispatch worker); a long third job
    detaches mid-flight. Both surviving jobs complete and are billed."""
    c = PlexCluster(n_groups=1,
                    device_plane=DevicePlane(devices=[torch.device("cpu")]))
    c.add_job(_tiny_job("grpo-job", seed=1))
    with c.serve():
        deadline = time.monotonic() + 240
        while not c.controllers["grpo-job"].reward_log:
            assert time.monotonic() < deadline, "grpo job made no progress"
            time.sleep(0.05)
        c.add_job(_tiny_job("ppo-job", seed=2), group_id=1, algo="ppo")
        c.add_job(_tiny_job("doomed", seed=3, steps=50), group_id=0)
        deadline = time.monotonic() + 240
        while c.controllers["doomed"].steps_completed < 1:
            assert time.monotonic() < deadline, "doomed job made no progress"
            time.sleep(0.05)
        removed = c.remove_job("doomed")
        assert removed.steps_completed >= 1
    for job in ("grpo-job", "ppo-job"):
        ctl = c.controllers[job]
        assert ctl.steps_completed == len(ctl.metrics_log) == 2, job
        assert len(ctl.reward_log) == 2, job
        assert all(np.isfinite(m["loss"]) for m in ctl.metrics_log), job
        rec = c.billing[job]
        assert rec.steps == 2 and rec.busy_seconds > 0.0, job
    rec = c.billing["doomed"]
    assert rec.steps >= 1 and rec.busy_seconds > 0.0
    ppo = c.controllers["ppo-job"]
    assert isinstance(ppo, RLControllerPPO)
    assert all({"pg_loss", "value_loss", "step"} <= m.keys()
               for m in ppo.metrics_log)
    # both roles ran and were billed under the job
    assert {d for d, s in c.router.deployments.items()
            if s.job_id == "ppo-job"} == {"ppo-job-train", "ppo-job-critic"}
    assert not [t for t in threading.enumerate()
                if t.name.startswith("serve-") and t.is_alive()]
    assert not c.router.pending
