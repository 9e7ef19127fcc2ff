"""Cost model of one step: FLOPs, bytes moved and each kernel's work.

The counterpart of ``repro.launch.hlo_cost``, under its name so a reader
finds it. It counts **dispatched ops**, not HLO: the step runs (on the
card, the CPU, or ``meta`` tensors, which compute nothing) under

one ``TorchDispatchMode`` that adds up, for each op,

- its FLOPs by ``torch.utils.flop_counter.FlopCounterMode``'s registry
  (``flop_registry``, what the FlopCounterMode context counts with): 2 a
  multiply-add of each matmul and convolution (``2·M·K·N`` for a matmul),
  the reference's dot count; elementwise ops count none, as there;
- its operand and result bytes (an in-place op's tensor once). Views and
  metadata ops count nothing, as the reference's ``_NO_TRAFFIC`` set.

(One mode, not a FlopCounterMode beside a byte mode: each op then crosses
one Python dispatch layer, not two, which takes a third off a full-width
dry run's time.)

A kernel wrapper of ``kernels/ops.py`` called inside adds its kernel's
analytic work (``flash_attention_work``, ``decode_attention_work``,
``ssd_work``) and one launch, and the ops of its plain version, meta route
or launcher are not counted. So one step counts the same on every device.
Backward ops count as dispatched: K1's backward recomputes the XLA
attention (``kernels/flash_attention.xla_attention``) over every
query-key pair, K3's the autodiff of ``ssd_chunked``, and a rematerialised
layer group's forward runs again, kernels included.

One card has no collectives: ``collective_bytes`` is 0.

    stats = analyze(step, params, batch)
    with Counter() as c:
        out = step(params, batch)
    stats = c.stats()
"""
from __future__ import annotations

import threading
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops as kops

# ops that move no bytes: they make a tensor without writing it, read
# metadata or a host scalar, or (``OpOverload.is_view``) alias their input
_NO_TRAFFIC = {
    "aten::empty", "aten::empty_like", "aten::empty_strided",
    "aten::new_empty", "aten::new_empty_strided", "aten::detach",
    "aten::lift_fresh", "aten::_local_scalar_dense", "aten::sym_size",
    "aten::sym_stride", "aten::sym_numel", "aten::sym_storage_offset",
    "aten::is_same_size", "aten::_has_compatible_shallow_copy_type",
    "aten::set_", "aten::resize_", "aten::_unsafe_view",
    "aten::_reshape_alias",
}


def _tensors(args, kwargs, out):
    """The tensors among an op's arguments and results (and in the lists
    and tuples there), each once."""
    seen = {}
    for group in (args, kwargs.values(), (out,)):
        for a in group:
            for t in (a if isinstance(a, (list, tuple)) else (a,)):
                if isinstance(t, torch.Tensor):
                    seen[id(t)] = t
    return seen.values()


class _CostMode(TorchDispatchMode):
    """Counts each dispatched op's FLOPs and bytes into its counter,
    unless the counter is inside a kernel wrapper's call."""

    def __init__(self, counter: "Counter"):
        super().__init__()
        self.counter = counter
        self.registry = FlopCounterMode(display=False).flop_registry
        self._rule: Dict[Any, Any] = {}   # op -> (counted, its FLOP rule)

    def _rule_of(self, func):
        rule = self._rule.get(func)
        if rule is None:
            counted = not (func.is_view or func._schema.name in _NO_TRAFFIC)
            rule = self._rule[func] = (
                counted, self.registry.get(func._overloadpacket))
        return rule

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.counter
        counted, flops = self._rule_of(func)
        if c.depth or not counted:
            return out
        flops = flops(*args, **kwargs, out_val=out) if flops else 0
        nbytes = sum(t.numel() * t.element_size()
                     for t in _tensors(args, kwargs, out))
        with c.lock:
            c.flops += flops
            c.traffic += nbytes
            c.ops += 1
        return out


class Counter:
    """Counts what runs inside ``with Counter() as c:``; ``c.stats()``
    gives the totals. Not reentrant; one at a time in a process."""

    def __init__(self):
        self.lock = threading.Lock()
        self.flops = 0
        self.traffic = 0
        self.ops = 0
        self.depth = 0            # > 0 inside a kernel wrapper's call
        self.kernels: Dict[str, Dict[str, int]] = {
            name: {"launches": 0, "flops": 0, "bytes": 0}
            for name in kops.LAUNCHES}

    # the kernel wrappers' hooks (kernels/ops.py: _kernel_call)
    def kernel_begin(self, name: str, flops: int, nbytes: int):
        with self.lock:
            k = self.kernels[name]
            k["launches"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes
            self.depth += 1

    def kernel_end(self):
        with self.lock:
            self.depth -= 1

    def __enter__(self):
        if kops.COUNTERS:
            raise RuntimeError("a cost Counter is already active")
        self._mode = _CostMode(self)
        self._mode.__enter__()
        kops.COUNTERS.append(self)
        return self

    def __exit__(self, *exc):
        kops.COUNTERS.remove(self)
        self._mode.__exit__(*exc)
        return False

    def stats(self) -> Dict[str, Any]:
        """The reference's keys (``flops``, ``traffic_bytes``,
        ``collective_bytes``), the dispatched ops counted and each kernel's
        launches and work. The kernels' work is inside ``flops`` and
        ``traffic_bytes``."""
        return {
            "flops": self.flops + sum(k["flops"]
                                      for k in self.kernels.values()),
            "traffic_bytes": self.traffic + sum(
                k["bytes"] for k in self.kernels.values()),
            "collective_bytes": 0,
            "ops": self.ops,
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
        }


def analyze(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` under a :class:`Counter` and return its
    stats (the function's result is dropped)."""
    with Counter() as c:
        fn(*args, **kwargs)
    return c.stats()
