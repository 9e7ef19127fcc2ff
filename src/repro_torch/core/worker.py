"""Worker-process group (WPG): one logical deployment's execution backend.

A WPG executes admitted operations SERIALLY (the per-WPG ordering
guarantee of §4.2/§5.1) on its node group's device, read off the group's
StateManager slice. Parameters live under the StateManager as canonical
entries, so context switching (offload/load) never touches worker code.

This serving slice runs ``INIT`` and ``GENERATE``; the training,
weight-sync and checkpoint ops raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
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
from repro_torch.rl import rollout as rollout_lib


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
    api.Op.UPDATE_ACTOR: "training",
    api.Op.FORWARD: "worker ops",
    api.Op.FORWARD_BACKWARD: "worker ops",
    api.Op.OPTIM_STEP: "worker ops",
    api.Op.SYNC_WEIGHTS: "worker ops",
    api.Op.SAVE_CHECKPOINT: "checkpoints",
    api.Op.LOAD_CHECKPOINT: "checkpoints",
}


class WorkerProcessGroup:
    def __init__(self, spec: api.DeploymentSpec, state_manager: StateManager,
                 rng_seed: int = 0):
        self.spec = spec
        self.sm = state_manager
        cfg = get_config(spec.model_name)
        if spec.overrides:
            cfg = cfg.replace(**dict(spec.overrides))
        self.cfg = cfg
        self.model: Model = build_model(cfg)
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

    def _store(self, params):
        self.sm.unregister(self.sm.keys_for(self.job_prefix, "params"))
        self.sm.register(self.job_prefix, params, Tier.DEVICE, "params")

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
            raise NotImplementedError(
                f"{qop.op.value} is not ported yet "
                f"(ROADMAP.md, Queue 1: {_NOT_PORTED[qop.op]})")
        handler = {api.Op.INIT: self._op_init,
                   api.Op.GENERATE: self._op_generate}[qop.op]
        t0 = time.monotonic()
        result = handler(*qop.args, **qop.kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.exec_log.append((qop.op.value, time.monotonic() - t0))
        return result

    # ------------------------------------------------------ op handlers
    def _op_init(self, seed: int = 0,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        """Seeded init on the group's device, or deploy ``params`` (a param
        tree, e.g. converted from the JAX package by models/convert.py)."""
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init_params(gen, self.device)
        else:
            params = common.tree_map(lambda t: t.to(self.device), params,
                                     is_leaf=torch.is_tensor)
        self._store(params)
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
