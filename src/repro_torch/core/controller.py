"""RLController: the algorithm side of the decoupling (paper §4.1).

The port of ``repro.core.controller``. A controller holds no model
state and expresses the RLVR loop purely through the remote service API:
generate -> (verify, pack) -> update actor. A step is a straight-line
dataflow chain against the client API: each ``Deployment`` method returns
a chainable future, ``.then(fn)`` interposes controller-side transforms
(packing rollouts into train batches, recording metrics), and passing a
future as the next op's argument is the dependency edge.

Controllers run under the serial ``run()`` loop (submit + ``drain()``),
``drive()`` against a live ``Router.serve()`` plane, or
:meth:`repro_torch.core.cluster.PlexCluster.run`, which steps several jobs
round-robin on one router and bills them. ``RLControllerGRPO`` runs one
train deployment; ``RLControllerPPO`` an actor and a critic.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.core.router import Router
from repro_torch.rl import data as data_lib
from repro_torch.rl import ppo as ppo_lib
from repro_torch.rl import reward as reward_lib


@dataclasses.dataclass
class JobConfig:
    job_id: str
    model_name: str
    batch_size: int = 8
    group_size: int = 4
    prompt_len: int = 12
    max_new_tokens: int = 16
    seq_len: int = 32
    steps: int = 4
    async_staleness: int = 0          # 0 = synchronous; 1 = one-step async
    seed: int = 0
    overrides: tuple = ()
    tenant: str = "default"           # owning tenant


class _RLControllerBase:
    """Shared client-side plumbing: one train deployment, the synthetic
    verifiable-math pipeline, rollout packing, and the two driver loops.
    Subclasses implement :meth:`submit_step` as a dataflow chain."""

    role_suffix = "train"

    def __init__(self, cfg: JobConfig, router: Router, group_id: int = 0):
        self.cfg = cfg
        self.router = router
        self.dataset = data_lib.MathDataset(seed=cfg.seed)
        self.batches = self.dataset.batches(cfg.batch_size, cfg.prompt_len,
                                            cfg.group_size)
        self.train_dep = api.DeploymentSpec(
            deployment_id=f"{cfg.job_id}-{self.role_suffix}",
            job_id=cfg.job_id,
            model_name=cfg.model_name, role="train",
            overrides=cfg.overrides)
        # rollout reuses the train deployment in this colocated runtime
        self.dep: api.Deployment = router.deploy(self.train_dep,
                                                 group_id=group_id)
        self.metrics_log: List[dict] = []
        self.reward_log: List[float] = []
        self.steps_completed = 0
        self._step_idx = 0
        # step index -> tail future of that step's weight update (the
        # one-step-async gate: a pure-ordering `after=` edge, no payload)
        self._updates: Dict[int, api.Future] = {}

    # ------------------------------------------------------------ pieces
    def submit_init(self) -> api.Future:
        return self.dep.init(self.cfg.seed, exec_estimate=1.0)

    def _pack(self, prompts, answers, gen_result,
              include_rewards: bool = False) -> Dict[str, torch.Tensor]:
        """Verify and pack a rollout into a train batch of CPU tensors (the
        WPG moves it to its device); with ``include_rewards`` the raw
        rewards too (a critic's value targets need them)."""
        toks = torch.as_tensor(gen_result["tokens"]).cpu().numpy()
        logps = torch.as_tensor(gen_result["logprobs"]).cpu().numpy()
        texts = [data_lib.decode(t) for t in toks]
        rewards = reward_lib.batch_rewards(texts, answers)
        self.reward_log.append(float(rewards.mean()))
        batch = data_lib.pack_rollout_batch(
            np.asarray(prompts), toks, logps, rewards,
            self.cfg.group_size, self.cfg.seq_len)
        out = {k: torch.from_numpy(v) for k, v in batch.items()}
        if include_rewards:
            out["rewards"] = torch.from_numpy(np.asarray(rewards))
        return out

    def _gate(self) -> tuple:
        """One-step-async staleness gate (§6.3): generation of step k waits
        on the update of step k-1-s, expressed as an `after=` future."""
        gate_idx = self._step_idx - 1 - self.cfg.async_staleness
        # entries older than the gate are dead: prune so a long-running
        # serviceized job holds at most staleness+2 update futures
        for k in [k for k in self._updates if k < gate_idx]:
            del self._updates[k]
        if gate_idx >= 0 and gate_idx in self._updates:
            return (self._updates[gate_idx],)
        return ()

    def _record_metrics(self, metrics: dict) -> dict:
        self.metrics_log.append(metrics)
        return metrics

    # ----------------------------------------------------------- the loop
    def submit_step(self, gen_estimate: float = 1.0,
                    train_estimate: float = 1.0) -> List[api.Future]:
        raise NotImplementedError

    def run(self):
        """Synchronous convenience loop (drives the router inline)."""
        init_f = self.submit_init()
        self.router.drain()
        init_f.result()
        tails: List[api.Future] = []
        if self.cfg.async_staleness:
            # pipeline: keep `staleness+1` steps in flight
            for _ in range(self.cfg.steps):
                tails += self.submit_step()
                self.router.step(max_ops=2)
            self.router.drain()
        else:
            for _ in range(self.cfg.steps):
                tails += self.submit_step()
                self.router.drain()
        for f in tails:
            f.result()          # a lost step is loud, not silently skipped
        self.steps_completed = self.cfg.steps
        return {"rewards": self.reward_log, "metrics": self.metrics_log}

    def drive(self, stop: Optional[threading.Event] = None,
              step_hook: Optional[Callable[[], None]] = None,
              step_timeout: float = 300.0):
        """Self-driving client loop against a live ``Router.serve()`` plane.

        Blocking; meant to run on the job's own client thread. Keeps
        ``async_staleness + 1`` steps in flight and waits on each step's
        tail future. ``stop`` detaches cooperatively: no new steps are
        submitted, and errors from operations the teardown poisoned are
        treated as a clean exit rather than failures."""
        try:
            if self.steps_completed == 0:
                self.submit_init().wait(timeout=step_timeout)
            inflight: collections.deque = collections.deque()
            for _ in range(self.cfg.steps - self.steps_completed):
                if stop is not None and stop.is_set():
                    break
                inflight.append(self.submit_step())
                while len(inflight) > self.cfg.async_staleness:
                    self._finish_step(inflight.popleft(), step_timeout,
                                      step_hook)
            while inflight:
                self._finish_step(inflight.popleft(), step_timeout,
                                  step_hook)
        except Exception:
            if stop is not None and stop.is_set():
                return          # detached mid-flight: poisons are expected
            raise

    def _finish_step(self, tails: List[api.Future], timeout: float,
                     step_hook: Optional[Callable[[], None]]):
        for f in tails:
            f.wait(timeout=timeout)
        self.steps_completed += 1
        if step_hook is not None:
            step_hook()


class RLControllerGRPO(_RLControllerBase):
    """One GRPO RLVR job written against the dataflow client API."""

    def submit_step(self, gen_estimate: float = 1.0,
                    train_estimate: float = 1.0) -> List[api.Future]:
        """Issue one RLVR step's operation chain (non-blocking).

        generate -> pack (controller-side) -> update_actor, as straight-line
        dataflow: the packed batch future is update_actor's argument, so its
        prerequisite edge and value splice are automatic. With
        ``async_staleness = s > 0`` generation is gated only on the update
        of step k-1-s (§6.3); the importance-sampling correction in GRPO
        absorbs the stale policy.
        """
        cfg = self.cfg
        prompts, problems = next(self.batches)
        answers = [p.answer for p in problems]

        gen_f = self.dep.generate(prompts, max_new_tokens=cfg.max_new_tokens,
                                  exec_estimate=gen_estimate,
                                  after=self._gate())
        batch_f = gen_f.then(
            lambda res: self._pack(prompts, answers, res))
        upd_f = self.dep.update_actor(batch_f, exec_estimate=train_estimate)
        self._updates[self._step_idx] = upd_f
        metrics_f = upd_f.then(self._record_metrics)
        self._step_idx += 1
        return [metrics_f]



class RLControllerPPO(_RLControllerBase):
    """PPO over the same service API as a TWO-ROLE job: an actor
    (role="train") and a critic deployment (role="critic", whose values
    are the worker's logsumexp readout), with the fused update split into
    the primitive ops (paper Tab. 2): GENERATE -> FORWARD (behavior
    logprobs) + critic FORWARD (values) -> GAE advantages (client-side) ->
    actor FORWARD_BACKWARD (clipped surrogate) + OPTIM_STEP ->
    SYNC_WEIGHTS re-basing the critic onto the updated actor -> critic
    FORWARD_BACKWARD (clipped value loss) + OPTIM_STEP on the fresh
    backbone (sync before the value step, so it is never clobbered)."""

    def __init__(self, cfg: JobConfig, router: Router, group_id: int = 0):
        super().__init__(cfg, router, group_id=group_id)
        self.ppo_cfg = ppo_lib.PPOConfig()
        self.critic_spec = api.DeploymentSpec(
            deployment_id=f"{cfg.job_id}-critic", job_id=cfg.job_id,
            model_name=cfg.model_name, role="critic",
            overrides=cfg.overrides)
        self.critic: api.Deployment = router.deploy(self.critic_spec,
                                                    group_id=group_id)

    def submit_init(self) -> api.Future:
        return api.gather(super().submit_init(),
                          self.critic.init(self.cfg.seed, exec_estimate=1.0))

    def _merge_ppo(self, triple):
        """Client-side join: behavior logprobs + critic values -> GAE
        advantages and the clipped value loss's targets."""
        batch, logp, values = triple
        toks = batch["tokens"].numpy()
        behave = np.zeros(toks.shape, np.float32)
        behave[:, 1:] = torch.as_tensor(logp).float().cpu().numpy()
        vals = torch.as_tensor(values).float().cpu().numpy()   # (B, S)
        mask = batch["loss_mask"].numpy().astype(np.float32)
        rewards = batch["rewards"].numpy().astype(np.float32)  # (B,)
        # terminal verifiable reward at the last response token
        r_seq = np.zeros(toks.shape, np.float32)
        last = (mask * np.arange(toks.shape[1])).argmax(axis=1)
        r_seq[np.arange(toks.shape[0]), last] = rewards
        adv = ppo_lib.gae_advantages(torch.from_numpy(r_seq),
                                     torch.from_numpy(vals),
                                     torch.from_numpy(mask),
                                     self.ppo_cfg).numpy()
        return dict(batch,
                    behavior_logprobs=torch.from_numpy(behave),
                    advantages=torch.from_numpy(adv),        # token-level
                    value_targets=torch.from_numpy(adv + vals),
                    old_values=torch.from_numpy(vals))

    def submit_step(self, gen_estimate: float = 1.0,
                    train_estimate: float = 1.0) -> List[api.Future]:
        cfg = self.cfg
        prompts, problems = next(self.batches)
        answers = [p.answer for p in problems]

        gen_f = self.dep.generate(prompts, max_new_tokens=cfg.max_new_tokens,
                                  exec_estimate=gen_estimate,
                                  after=self._gate())
        batch_f = gen_f.then(
            lambda res: self._pack(prompts, answers, res,
                                   include_rewards=True))
        # behavior logprobs under the pre-update policy (the first ratio is
        # exactly 1) and the critic's values, as FORWARD ops on both roles
        logp_f = self.dep.forward(batch_f, exec_estimate=train_estimate)
        vals_f = self.critic.forward(batch_f, output="values",
                                     exec_estimate=train_estimate)
        merged_f = api.gather(batch_f, logp_f, vals_f).then(self._merge_ppo)
        fb_f = self.dep.forward_backward(merged_f, objective="ppo",
                                         exec_estimate=train_estimate)
        opt_f = self.dep.optim_step(fb_f.then(lambda r: r["grads"]),
                                    exec_estimate=train_estimate)
        # once the actor updated, re-base the critic onto it, THEN take the
        # value step on top (old_values were read under the pre-step critic)
        sync_f = self.dep.sync_weights(self.critic,
                                       exec_estimate=train_estimate,
                                       after=(opt_f,))
        vfb_f = self.critic.forward_backward(merged_f, objective="value",
                                             exec_estimate=train_estimate,
                                             after=(sync_f,))
        vopt_f = self.critic.optim_step(vfb_f.then(lambda r: r["grads"]),
                                        exec_estimate=train_estimate)
        self._updates[self._step_idx] = vopt_f

        def _record(triple):
            fb, opt_res, vfb = triple
            metrics = {k: float(v) for k, v in fb["metrics"].items()}
            metrics["value_loss"] = float(vfb["metrics"]["value_loss"])
            metrics.update(opt_res)
            return self._record_metrics(metrics)

        metrics_f = api.gather(fb_f, opt_f, vfb_f).then(_record)
        self._step_idx += 1
        return [metrics_f, vopt_f]
