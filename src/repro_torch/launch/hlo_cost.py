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

The collectives of ``models/sharding.py`` (over a mesh of several
devices) record, by kind, the result bytes each receiving device gets and
how many receive them (``stats()["collectives"]``,
``collective_bytes``), the reference's convention (the result shapes of
the HLO's collectives); the copies and sums that carry them out count as
no op. One card has none: ``collective_bytes`` is 0. Counts sum over
the devices one process drives: ``launch/dryrun.py`` divides a mesh's
by its devices.

The same mode also tracks the step's live bytes, the counterpart of the
reference's ``compiled.memory_analysis()`` (:class:`LiveBytes`): each
op's results that alias none of its operands
count, by their storage's bytes, from the op until the last reference to
that storage dies; views and in-place results cost nothing, and a storage
counts once. Inside a kernel wrapper's call only the storages still alive
when the call returns count (its outputs), so its plain version's
intermediates on the CPU and a launcher's transient copies on the card
count on neither, as on ``meta``. ``stats()["peak_live_bytes"]`` is the
most that was alive at once: what the step adds to its arguments at its
peak. XLA fuses ops and reuses buffers where eager PyTorch allocates, so
the figure is not XLA's.

    stats = analyze(step, params, batch)
    with Counter() as c:
        out = step(params, batch)
    stats = c.stats()
"""
from __future__ import annotations

import threading
import weakref
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


class LiveBytes:
    """The peak of the live bytes of the storages a step creates (see the
    module's docstring). Storages are told apart by their Python objects,
    which PyTorch keeps alive, and so at one ``id``, as long as the
    storage lives; a finalizer on each drops its bytes when it dies, on
    whichever thread lets it go."""

    def __init__(self):
        self.lock = threading.RLock()    # finalizers may run inside a note
        self.live = 0
        self.peak = 0
        self.sizes: Dict[int, int] = {}  # id -> bytes of counted storages
        # made inside a kernel wrapper's call, counted once it returns
        self.inside: Dict[int, int] = {}

    @staticmethod
    def _storages(tensors):
        return [t.untyped_storage() for t in tensors
                if isinstance(t, torch.Tensor)]

    def note(self, operands, results, inside: bool) -> None:
        """One op's results: count each storage that none of its operands
        holds and that is not counted yet."""
        held = {id(st) for st in self._storages(operands)}
        for st in self._storages(results):
            key = id(st)
            with self.lock:
                if key in held or key in self.sizes or key in self.inside:
                    continue
                nbytes = st.nbytes()
                if inside:
                    self.inside[key] = nbytes
                else:
                    self._count(key, nbytes)
            weakref.finalize(st, self._free, key).atexit = False

    def _count(self, key: int, nbytes: int) -> None:
        self.sizes[key] = nbytes
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def kernel_returned(self) -> None:
        """The storages made inside the call that are still alive are its
        outputs: count them from now on."""
        with self.lock:
            for key, nbytes in self.inside.items():
                self._count(key, nbytes)
            self.inside.clear()

    def _free(self, key: int) -> None:
        with self.lock:
            if self.inside.pop(key, None) is None:
                self.live -= self.sizes.pop(key, 0)


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
        if not func.is_view:
            c.memory.note(_tensors(args, kwargs, ()),
                          _tensors((), {}, out), inside=c.depth > 0)
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
        self.collectives: Dict[str, Dict[str, int]] = {
            kind: {"bytes": 0, "count": 0} for kind in kops.COLLECTIVES}
        self.memory = LiveBytes()

    # the kernel wrappers' hooks (kernels/ops.py: _kernel_call)
    def kernel_begin(self, name: str, flops: int, nbytes: int):
        with self.lock:
            k = self.kernels[name]
            k["launches"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes
            self.depth += 1

    # the collectives' hook (kernels/ops.py: collective)
    def collective_begin(self, kind: str, nbytes: int, receivers: int):
        with self.lock:
            c = self.collectives[kind]
            c["bytes"] += nbytes * receivers
            c["count"] += receivers
            self.depth += 1

    def kernel_end(self):
        with self.lock:
            self.depth -= 1
            outermost = self.depth == 0
        if outermost:
            self.memory.kernel_returned()

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
        ``traffic_bytes``. ``peak_live_bytes`` is the most the step's own
        storages held at once."""
        return {
            "flops": self.flops + sum(k["flops"]
                                      for k in self.kernels.values()),
            "traffic_bytes": self.traffic + sum(
                k["bytes"] for k in self.kernels.values()),
            "collective_bytes": sum(c["bytes"]
                                    for c in self.collectives.values()),
            "ops": self.ops,
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "collectives": {k: dict(v) for k, v in self.collectives.items()},
            "peak_live_bytes": self.memory.peak,
        }


def analyze(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` under a :class:`Counter` and return its
    stats (the function's result is dropped)."""
    with Counter() as c:
        fn(*args, **kwargs)
    return c.stats()
