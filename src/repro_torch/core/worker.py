"""Worker-process group (WPG): one logical deployment's execution backend.

A WPG executes admitted operations SERIALLY (the per-WPG ordering
guarantee of §4.2/§5.1) on its node group's device, read off the group's
StateManager slice. Parameters live under the StateManager as canonical
entries, so context switching (offload/load) never touches worker code.

It runs ``INIT``, ``GENERATE`` and the GRPO training ops: ``FORWARD``
(logprobs), ``FORWARD_BACKWARD`` (the GRPO objective), ``OPTIM_STEP``
(AdamW on the device), ``UPDATE_ACTOR`` and ``SYNC_WEIGHTS``. A train or
critic deployment also keeps its AdamW state under the StateManager
(``opt`` entries), so a context switch moves it with the parameters. An
update writes the new parameters and moments INTO the registered device
tensors (the reference re-registers a new tree), so the entries and their
pinned host buffers outlive every step. The PPO readouts and objectives,
the host optimizer step and the checkpoint ops raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.core import api
from repro_torch.core.state_manager import StateManager, Tier
from repro_torch.models import common
from repro_torch.models.registry import Model, build_model
from repro_torch.rl import grpo
from repro_torch.rl import rollout as rollout_lib
from repro_torch.train import optimizer as opt
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


# op -> the ROADMAP item (Queue 1) that ports its handler
_NOT_PORTED = {
    api.Op.SAVE_CHECKPOINT: "checkpoints",
    api.Op.LOAD_CHECKPOINT: "checkpoints",
}


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1: {item})")


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
        self.adamw_cfg = adamw_cfg or opt.AdamWConfig()
        self._update_actor = grpo.make_update_actor(
            self.model, self.grpo_cfg, self.adamw_cfg)
        self._logprob = grpo.make_compute_log_prob(self.model)
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.exec_log = ExecLog()

    # -------------------------------------------------------------- state
    @property
    def job_prefix(self) -> str:
        return f"{self.spec.job_id}:{self.spec.deployment_id}"

    @property
    def device(self) -> torch.device:
        """The node group's device, read off the group's StateManager."""
        return self.sm.device

    def params(self):
        return self.sm.gather(self.job_prefix, self.model.param_specs(),
                              "params")

    def opt_state(self) -> opt.AdamWState:
        specs = self.model.param_specs()
        return opt.AdamWState(**self.sm.gather(
            self.job_prefix, {"step": None, "mu": specs, "nu": specs}, "opt"))

    def _register(self, prefix: str, tree):
        """Register a new tree under ``prefix`` ("params" or "opt"): INIT,
        or the target of a weight sync."""
        self.sm.unregister(self.sm.keys_for(self.job_prefix, prefix))
        self.sm.register(self.job_prefix, tree, Tier.DEVICE, prefix)

    def _write(self, params, opt_state: opt.AdamWState):
        """An update: new values into the registered tensors, in place."""
        self.sm.write(self.job_prefix, params, "params")
        self.sm.write(self.job_prefix, opt_state._asdict(), "opt")

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

    def offload(self) -> float:
        """Move this WPG's state to pinned host memory (the 'offload' half
        of a context switch). Returns elapsed seconds."""
        return self.sm.offload(self.sm.keys_for(self.job_prefix))

    # --------------------------------------------------------------- ops
    def execute(self, qop: api.QueuedOperation):
        """Serial execution of one admitted operation. The device is
        synchronized before the op's seconds are logged, so billing records
        the run time, not the enqueue time."""
        if qop.op in _NOT_PORTED:
            raise _not_ported(qop.op.value, _NOT_PORTED[qop.op])
        handler = {
            api.Op.INIT: self._op_init,
            api.Op.GENERATE: self._op_generate,
            api.Op.FORWARD: self._op_forward,
            api.Op.FORWARD_BACKWARD: self._op_forward_backward,
            api.Op.OPTIM_STEP: self._op_optim_step,
            api.Op.UPDATE_ACTOR: self._op_update_actor,
            api.Op.SYNC_WEIGHTS: self._op_sync_weights,
        }[qop.op]
        t0 = time.monotonic()
        result = handler(*qop.args, **qop.kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.exec_log.append((qop.op.value, time.monotonic() - t0))
        return result

    # ------------------------------------------------------ op handlers
    def _op_init(self, seed: int = 0,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        """Seeded init on the group's device, or deploy a copy of ``params``
        (a param tree, e.g. converted from the JAX package by
        models/convert.py). Train and critic deployments also get zero
        AdamW moments."""
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init_params(gen, self.device)
        else:
            # a copy: updates write into the stored tensors in place
            params = common.tree_map(
                lambda t: t.to(self.device, copy=True), params)
        self._register("params", params)
        if self.spec.role in ("train", "critic"):
            self._register("opt", opt.init(params, self.adamw_cfg)._asdict())
        return {"params": self.model.param_count()}

    def _op_generate(self, prompt_tokens, max_new_tokens: int = 32,
                     temperature: float = 1.0):
        tokens = torch.as_tensor(prompt_tokens, dtype=torch.long,
                                 device=self.device)
        with torch.inference_mode():
            toks, logps, alive = rollout_lib.rollout(
                self.model, self.params(), tokens, self._gen,
                rollout_lib.RolloutConfig(max_new_tokens=max_new_tokens,
                                          temperature=temperature))
        return {"tokens": toks, "logprobs": logps, "alive": alive}

    def _op_forward(self, batch, output: str = "logprobs"):
        """Forward-only primitive: next-token logprobs (compute_log_prob)."""
        if output == "values":
            raise _not_ported("FORWARD(output='values')", "PPO")
        if output != "logprobs":
            raise ValueError(f"unknown forward output {output!r}")
        with torch.no_grad():
            return self._logprob(self.params(), self._batch(batch))

    def _op_forward_backward(self, batch, objective: str = "grpo"):
        """Split-phase gradient computation of the GRPO objective."""
        if objective in ("ppo", "value"):
            raise _not_ported(f"FORWARD_BACKWARD(objective={objective!r})",
                              "PPO")
        if objective != "grpo":
            raise ValueError(f"unknown objective {objective!r}")
        grads, metrics = grpo.compute_grads(self.params(), self.model,
                                            self._batch(batch), self.grpo_cfg)
        return {"grads": grads, "metrics": metrics}

    def _op_optim_step(self, grads, host: bool = False):
        if host:
            raise _not_ported("OPTIM_STEP(host=True)", "PPO")
        new_params, new_state, metrics = opt.update(
            grads, self.opt_state(), self.params(), self.adamw_cfg)
        self._write(new_params, new_state)
        return {"step": int(new_state.step),
                **{k: float(v) for k, v in metrics.items()}}

    def _op_update_actor(self, batch):
        state = TrainState(self.params(), self.opt_state(),
                           torch.zeros((), dtype=torch.int32))
        new_state, metrics = self._update_actor(state, self._batch(batch))
        self._write(new_state.params, new_state.opt_state)
        return {k: float(v) for k, v in metrics.items()}

    def _op_sync_weights(self, target_wpg: "WorkerProcessGroup",
                         target_shardings=None):
        """Give the rollout deployment ``target_wpg`` a COPY of this
        deployment's parameters on its device: later in-place updates here
        leave its weights as they were synced."""
        if target_shardings is not None:
            raise _not_ported("SYNC_WEIGHTS into target shardings",
                              "sharding")
        target_wpg._register("params", self.sm.sync_weights(
            self.job_prefix, self.model.param_specs(), target_wpg.device))
        return {"synced_bytes": self.sm.job_bytes(self.job_prefix)}
