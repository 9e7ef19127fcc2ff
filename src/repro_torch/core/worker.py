"""Worker-process group (WPG): one logical deployment's execution backend.

A WPG executes admitted operations SERIALLY (the per-WPG ordering
guarantee of §4.2/§5.1) on its node group's mesh slice, read off the
group's StateManager (so a migration that swaps the StateManager rebinds
the WPG). Parameters live under the StateManager as canonical entries, so
context switching (offload/load) never touches worker code. On a slice of
several devices the WPG lays its state out by the model's ``"tp"`` rules
(:meth:`state_shardings`, cached per slice), runs every op tensor-parallel
over the slice (``models/layers.py``'s ``Ctx``) and syncs weights into the
target deployment's own layout; every family runs there, in the Router's
process or in a process-plane child that sees the slice.

It runs every op of the service API: ``INIT``, ``GENERATE``, ``FORWARD``
(logprobs, or a critic's values), ``FORWARD_BACKWARD`` (the GRPO, PPO or
value objective), ``OPTIM_STEP`` (AdamW on the device, or the
StateManager's host step), ``UPDATE_ACTOR``, ``SYNC_WEIGHTS`` and the
checkpoint ops. A train or critic deployment also keeps its AdamW state
under the StateManager (``opt`` entries), so a context switch moves it
with the parameters. An update writes the new parameters and moments INTO
the registered tensors, leaf by leaf (``optimizer.update_``; the
reference re-registers a new tree), so the entries and their pinned host
buffers outlive every step; a weight sync or a checkpoint load into a
deployment that holds parameters writes into them too.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import api
from repro_torch.core.state_manager import StateManager, Tier
from repro_torch.models import common
from repro_torch.models import sharding as shd
from repro_torch.models.layers import make_ctx
from repro_torch.models.registry import Model, build_model
from repro_torch.rl import grpo
from repro_torch.rl import ppo as ppo_lib
from repro_torch.rl import rollout as rollout_lib
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import train_state as tstate
from repro_torch.train.train_state import TrainState


class ExecLog:
    """Bounded execution log with ABSOLUTE offsets.

    Billing consumes the log through incremental cursors; the ring drops the
    oldest entries past ``maxlen`` while ``offset`` tracks the absolute index
    of the first retained entry, so cursors keep meaning "ops billed so far"
    across trims. ``len``/iteration/indexing cover the RETAINED window;
    :meth:`since` is the billing protocol."""

    def __init__(self, maxlen: int = 4096):
        self.maxlen = maxlen
        self.offset = 0                      # absolute index of _items[0]
        self._items: List[Tuple[str, float]] = []

    def append(self, item):
        self._items.append(item)
        if len(self._items) > self.maxlen:
            drop = len(self._items) - self.maxlen
            del self._items[:drop]
            self.offset += drop

    def since(self, cursor: int) -> Tuple[List[Tuple[str, float]], int]:
        """Entries at absolute index >= ``cursor`` (clamped to the retained
        window) and the new cursor."""
        start = max(int(cursor), self.offset)
        return self._items[start - self.offset:], self.offset + len(self._items)

    def total(self) -> int:
        return self.offset + len(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, i):
        return self._items[i]


def _value_readout(logits):
    """Critic value estimate per token without a dedicated value head: the
    free energy (logsumexp) of the f32 logits, squashed to (-1, 1) by tanh
    of it over sqrt(V). Differentiable in the whole backbone, so the
    clipped value loss trains a role="critic" deployment through the same
    FORWARD_BACKWARD / OPTIM_STEP primitives as the actor."""
    v = torch.logsumexp(logits.float(), dim=-1)
    return torch.tanh(v / (logits.shape[-1] * 1.0) ** 0.5)


class WorkerProcessGroup:
    def __init__(self, spec: api.DeploymentSpec, state_manager: StateManager,
                 rng_seed: int = 0, grpo_cfg: Optional[grpo.GRPOConfig] = None,
                 adamw_cfg: Optional[opt.AdamWConfig] = None):
        self.spec = spec
        self.sm = state_manager
        cfg = get_config(spec.model_name)
        if spec.overrides:
            cfg = cfg.replace(**dict(spec.overrides))
        self.cfg = cfg
        self.model: Model = build_model(cfg)
        self.grpo_cfg = grpo_cfg or grpo.GRPOConfig()
        self.ppo_cfg = ppo_lib.PPOConfig()
        self.adamw_cfg = adamw_cfg or opt.AdamWConfig()
        self._update_actor = grpo.make_update_actor(
            self.model, self.grpo_cfg, self.adamw_cfg)
        self._logprob = grpo.make_compute_log_prob(self.model)
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.exec_log = ExecLog()
        # (mesh, TrainState of shardings), rebuilt when the slice changes
        self._shard_cache: Optional[tuple] = None

    # -------------------------------------------------------------- state
    @property
    def job_prefix(self) -> str:
        return f"{self.spec.job_id}:{self.spec.deployment_id}"

    @property
    def device(self) -> torch.device:
        """The node group's (first) device, read off the group's
        StateManager."""
        return self.sm.device

    @property
    def mesh_slice(self):
        """The node group's MeshSlice, read off the group's StateManager."""
        return getattr(self.sm, "mesh_slice", None)

    def ctx(self):
        """The sharding context of a slice of several devices, else None
        (the one-device path)."""
        sl = self.mesh_slice
        return None if sl is None else make_ctx(sl.mesh)

    def state_shardings(self) -> Optional[TrainState]:
        """The shardings of (params, opt_state, step) on this group's
        slice under the ``"tp"`` rules, cached per slice; None over one
        device."""
        sl = self.mesh_slice
        if sl is None or sl.n_devices == 1:
            return None
        if self._shard_cache is None or self._shard_cache[0] != sl.mesh:
            self._shard_cache = (sl.mesh, tstate.shardings(
                self.model, sl.mesh, shd.named_rules("tp")))
        return self._shard_cache[1]

    def param_shardings(self):
        st = self.state_shardings()
        return None if st is None else st.params

    def _place(self, tree, shardings):
        """A copy of ``tree`` on the group's slice: in ``shardings`` over
        several devices, else on the device."""
        if shardings is None:
            return common.tree_map(lambda t: shd.gather(t).to(
                self.device, copy=True), tree)
        return shd.device_put(tree, shardings)

    def params(self):
        return self.sm.gather(self.job_prefix, self.model.param_specs(),
                              "params")

    def host_params(self):
        """The parameters as host tensors: the process plane's export for a
        weight sync into another process."""
        return common.tree_map(lambda t: shd.gather(t, "cpu").detach(),
                               self.params())

    def opt_state(self) -> opt.AdamWState:
        specs = self.model.param_specs()
        return opt.AdamWState(**self.sm.gather(
            self.job_prefix, {"step": None, "mu": specs, "nu": specs}, "opt"))

    def _register(self, prefix: str, tree):
        """Register a new tree under ``prefix`` ("params" or "opt"): INIT,
        or the target of a weight sync."""
        self.sm.unregister(self.sm.keys_for(self.job_prefix, prefix))
        self.sm.register(self.job_prefix, tree, Tier.DEVICE, prefix)

    def _store_params(self, tree, shardings=None):
        """Parameters from a weight sync or a checkpoint: written into the
        registered tensors where the deployment holds some, else
        registered (a copy laid out in ``shardings``, by default
        :meth:`param_shardings`; on the group's device over one device).
        Either way the tree is copied, so its leaves may be views over
        memory that is reused once this returns (the process plane's
        shared segments)."""
        if self.sm.keys_for(self.job_prefix, "params"):
            self.sm.write(self.job_prefix, tree, "params")
        else:
            self._register("params", self._place(
                tree, self.param_shardings() if shardings is None
                else shardings))

    def _batch(self, batch):
        """A train batch (numpy or CPU tensors) on the group's device."""
        out = {k: torch.as_tensor(v, device=self.device)
               for k, v in batch.items()}
        out["tokens"] = out["tokens"].long()
        return out

    def resident(self) -> bool:
        keys = self.sm.keys_for(self.job_prefix)
        return bool(keys) and all(
            self.sm.entries[k].tier == Tier.DEVICE for k in keys)

    def ensure_resident(self) -> float:
        """Load this WPG's state to the device (the 'load' half of a
        context switch). Returns elapsed seconds."""
        return self.sm.prefetch(self.sm.keys_for(self.job_prefix))

    def offload(self, to: Tier = Tier.HOST) -> float:
        """Move this WPG's state to pinned host memory (the 'offload' half
        of a context switch), or to DISK. Returns elapsed seconds."""
        return self.sm.offload(self.sm.keys_for(self.job_prefix), to)

    # --------------------------------------------------------------- ops
    def execute(self, qop: api.QueuedOperation):
        """Serial execution of one admitted operation. The device is
        synchronized before the op's seconds are logged, so billing records
        the run time, not the enqueue time."""
        handler = {
            api.Op.INIT: self._op_init,
            api.Op.GENERATE: self._op_generate,
            api.Op.FORWARD: self._op_forward,
            api.Op.FORWARD_BACKWARD: self._op_forward_backward,
            api.Op.OPTIM_STEP: self._op_optim_step,
            api.Op.UPDATE_ACTOR: self._op_update_actor,
            api.Op.SYNC_WEIGHTS: self._op_sync_weights,
            api.Op.SAVE_CHECKPOINT: self._op_save_checkpoint,
            api.Op.LOAD_CHECKPOINT: self._op_load_checkpoint,
        }[qop.op]
        t0 = time.monotonic()
        result = handler(*qop.args, **qop.kwargs)
        self.sm._sync()
        self.exec_log.append((qop.op.value, time.monotonic() - t0))
        return result

    # ------------------------------------------------------ op handlers
    def _op_init(self, seed: int = 0,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        """Seeded init on the group's device, or deploy a copy of ``params``
        (a param tree, e.g. converted from the JAX package by
        models/convert.py). Train and critic deployments also get zero
        AdamW moments. On a slice of several devices the state is laid
        out in :meth:`state_shardings` (the seeded init drawn whole on the
        first device first, so every slice size holds the same
        values)."""
        st = self.state_shardings()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init_params(gen, self.device)
            if st is not None:
                params = shd.device_put(params, st.params)
        else:
            # a copy: updates write into the stored tensors in place
            params = self._place(params, None if st is None else st.params)
        self._register("params", params)
        if self.spec.role in ("train", "critic"):
            state = opt.init(params, self.adamw_cfg)
            if st is not None:
                # the moments in ZeRO's specs (the parameters' blocks: the
                # data axis of a slice is 1)
                mom = st.opt_state
                state = opt.AdamWState(
                    shd.shard(state.step, mom.step),
                    shd.relayout(state.mu, mom.mu),
                    shd.relayout(state.nu, mom.nu))
            self._register("opt", state._asdict())
        return {"params": self.model.param_count()}

    def _op_generate(self, prompt_tokens, max_new_tokens: int = 32,
                     temperature: float = 1.0, extra_inputs=None):
        """A rollout of ``prompt_tokens``; every tensor or numpy array of
        ``extra_inputs`` (whisper's ``frames``, vlm's ``vision``) goes to
        the group's (first) device and joins the prefill's batch; over a
        slice the model places it on every device."""
        tokens = torch.as_tensor(prompt_tokens, dtype=torch.long,
                                 device=self.device)
        extra = {k: torch.as_tensor(v, device=self.device)
                 if isinstance(v, (torch.Tensor, np.ndarray)) else v
                 for k, v in (extra_inputs or {}).items()}
        with torch.inference_mode():
            toks, logps, alive = rollout_lib.rollout(
                self.model, self.params(), tokens, self._gen,
                rollout_lib.RolloutConfig(max_new_tokens=max_new_tokens,
                                          temperature=temperature),
                extra_inputs=extra, ctx=self.ctx())
        return {"tokens": toks, "logprobs": logps, "alive": alive}

    def _op_forward(self, batch, output: str = "logprobs"):
        """Forward-only primitive. ``output`` selects the readout:
        "logprobs" (compute_log_prob, default) or "values" (a critic's
        value estimates per token)."""
        if output not in ("logprobs", "values"):
            raise ValueError(f"unknown forward output {output!r}")
        with torch.no_grad():
            if output == "values":
                logits, _ = self.model.forward(self.params(),
                                               self._batch(batch),
                                               ctx=self.ctx())[:2]
                return _value_readout(logits)
            return self._logprob(self.params(), self._batch(batch),
                                 self.ctx())

    def _op_forward_backward(self, batch, objective: str = "grpo"):
        """Split-phase gradient computation. ``objective`` selects the loss:
        "grpo" (default), "ppo" (rl/ppo.py's clipped surrogate) or "value"
        (the clipped critic loss of a role="critic" deployment)."""
        params, batch, ctx = self.params(), self._batch(batch), self.ctx()
        if objective == "grpo":
            grads, metrics = grpo.compute_grads(params, self.model, batch,
                                                self.grpo_cfg, ctx=ctx)
            return {"grads": grads, "metrics": metrics}
        if objective == "ppo":
            def loss_fn(p):
                return ppo_lib.ppo_loss(p, self.model, batch, self.ppo_cfg,
                                        ctx)
        elif objective == "value":
            def loss_fn(p):
                logits, aux = self.model.forward(p, batch, ctx=ctx)[:2]
                vl = ppo_lib.value_loss(
                    _value_readout(logits), batch["value_targets"],
                    batch["old_values"], batch["loss_mask"], self.ppo_cfg)
                return vl + 0.01 * aux, {"value_loss": vl}
        else:
            raise ValueError(f"unknown objective {objective!r}")
        grads, metrics = grpo.value_and_grad(loss_fn, params)
        return {"grads": common.canonical_unflatten(params, grads),
                "metrics": metrics}

    def _op_optim_step(self, grads, host: bool = False):
        """AdamW on the device, or the StateManager's host step. Over a
        slice, gradients that arrive whole (from the process plane's pipe)
        are laid out in the parameters' layout first."""
        if host:
            # §4.5.4: CPU optimizer over host-resident canonical state
            step = self.sm.host_optimizer_step(
                self.job_prefix, grads, self.model.param_specs(),
                lr=self.adamw_cfg.lr, b1=self.adamw_cfg.b1,
                b2=self.adamw_cfg.b2, eps=self.adamw_cfg.eps)
            return {"step": step, "host": True}
        state, params = self.opt_state(), self.params()
        pflat = common.canonical_flat(params)
        grads = common.canonical_unflatten(params, {
            k: shd.shard(g, pflat[k].sharding)
            if isinstance(pflat[k], shd.Sharded)
            and not isinstance(g, shd.Sharded) else g
            for k, g in common.canonical_flat(grads).items()})
        metrics = opt.update_(grads, state, params, self.adamw_cfg)
        return {"step": int(shd.local_tensors(state.step)[0]),
                **{k: float(v) for k, v in metrics.items()}}

    def _op_update_actor(self, batch):
        state = TrainState(self.params(), self.opt_state(),
                           torch.zeros((), dtype=torch.int32))
        _, metrics = self._update_actor(state, self._batch(batch),
                                        self.ctx())
        return {k: float(v) for k, v in metrics.items()}

    def _op_sync_weights(self, target_wpg: "WorkerProcessGroup",
                         target_shardings=None):
        """Give the deployment ``target_wpg`` this deployment's parameters
        in its layout (``repro/core/worker.py:322-331``): by default the
        target's own shardings on its slice (a copy on its device over one
        device), or ``target_shardings``; written into the tensors it
        holds, or registered. Later in-place updates here leave its
        weights as they were synced."""
        if target_shardings is None and hasattr(target_wpg,
                                                "param_shardings"):
            target_shardings = target_wpg.param_shardings()
        tree = self.sm.sync_weights(self.job_prefix, self.model.param_specs(),
                                    target_shardings)
        target_wpg._store_params(tree, target_shardings)
        return {"synced_bytes": self.sm.job_bytes(self.job_prefix)}

    def _op_save_checkpoint(self, path: str, step: int = 0):
        return self.sm.materialize_checkpoint(
            self.job_prefix, self.model.param_specs(), path, step)

    def _op_load_checkpoint(self, path: str):
        tree, meta = ckpt.restore(path, self.model.param_specs())
        self._store_params(tree)
        return meta
