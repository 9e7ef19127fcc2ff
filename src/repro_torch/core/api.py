"""Serviceized execution API (paper §4.2): the narrow remote interface.

Algorithm code (RLController) sees only logical deployments and a small set
of primitive operations; placement, parallelism, state movement, and
ordering are the system's concern.

Client surface (the dataflow API)
---------------------------------
:class:`Deployment` is the bound client handle a controller programs
against: ``dep.generate(...)``, ``dep.update_actor(...)`` etc. submit one
operation each and return a chainable :class:`Future`.

- ``future.then(fn)`` derives a new future resolving to ``fn(result)``
  (errors propagate past ``fn``; an exception inside ``fn`` becomes the
  derived future's error).
- :func:`gather` joins several futures into one resolving to the list of
  results.
- Any :class:`Future` passed as an operation *argument* is a dataflow edge:
  the futures' source operations are registered as prerequisites
  automatically, the Router holds the op until they settle, and the resolved
  values are spliced into the arguments at dispatch time. No manual
  ``req_id`` wiring, no nested callbacks.

``make_op`` + ``Router.submit_queued_operation`` remain the low-level
escape hatch underneath (explicit req_id prerequisites, custom arrival
times); everything the handle does compiles down to them.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple


class Op(enum.Enum):
    INIT = "init"                       # deployment lifecycle
    GENERATE = "generate"               # rollout (prefill + decode loop)
    FORWARD = "forward"                 # compute_log_prob / reward model
    FORWARD_BACKWARD = "forward_backward"
    OPTIM_STEP = "optim_step"
    UPDATE_ACTOR = "update_actor"       # fused fwd+bwd+step
    SYNC_WEIGHTS = "sync_weights"
    SAVE_CHECKPOINT = "save_checkpoint"
    LOAD_CHECKPOINT = "load_checkpoint"


@dataclasses.dataclass(frozen=True)
class DeploymentSpec:
    """One logical deployment -> one worker-process group (WPG)."""
    deployment_id: str
    job_id: str
    model_name: str                     # repro_torch.configs registry id
    role: str                           # "train" | "rollout" | "reference" | "critic"
    nodes: int = 1
    parallelism: Tuple[Tuple[str, int], ...] = ()   # e.g. (("data",2),("model",4))
    overrides: Tuple[Tuple[str, Any], ...] = ()     # ModelConfig.replace kwargs


class _CallbackList:
    """Back-compat shim: ``future.callbacks.append(cb)`` must stay race-safe
    now that operations complete on dispatch worker threads, so appends are
    routed through :meth:`Future.add_done_callback`."""

    __slots__ = ("_future",)

    def __init__(self, future: "Future"):
        self._future = future

    def append(self, cb: Callable[["Future"], None]):
        self._future.add_done_callback(cb)


class Future:
    """Thread-safe future for the non-blocking control plane (§5.2.2).

    Completion is signalled through a condition variable so any thread can
    block in :meth:`wait`; callbacks are fired OUTSIDE the internal lock
    because a callback may submit follow-up operations that resolve further
    futures (possibly on other dispatch threads).

    ``sources`` is the dataflow provenance: the req_ids of the operations
    this value (transitively) derives from. Submitting a future as an op
    argument turns its sources into scheduler prerequisites, so by the time
    the dependent op is admitted the future is resolved (or about to be, in
    the narrow window between a source op's COMPLETED transition and its
    callback chain firing — dispatch bridges that with a bounded wait).
    """

    __slots__ = ("_cond", "_done", "_result", "_error", "_callbacks",
                 "callbacks", "sources")

    def __init__(self, sources: Tuple[int, ...] = ()):
        self._cond = threading.Condition()
        self._done = False
        self._result = None
        self._error: Optional[BaseException] = None
        self._callbacks: List[Callable[["Future"], None]] = []
        self.callbacks = _CallbackList(self)
        self.sources: Tuple[int, ...] = tuple(sources)

    # ------------------------------------------------------------ resolve
    def _resolve(self, result, error: Optional[BaseException]):
        with self._cond:
            if self._done:
                raise RuntimeError("future already resolved")
            self._result = result
            self._error = error
            self._done = True
            cbs, self._callbacks = self._callbacks, []
            self._cond.notify_all()
        for cb in cbs:
            cb(self)

    def set_result(self, value):
        self._resolve(value, None)

    def set_error(self, err: BaseException):
        self._resolve(None, err)

    # ------------------------------------------------------------ observe
    def add_done_callback(self, cb: Callable[["Future"], None]):
        """Register ``cb(future)``; fires immediately if already resolved."""
        with self._cond:
            if not self._done:
                self._callbacks.append(cb)
                return
        cb(self)

    def done(self) -> bool:
        return self._done

    def wait(self, timeout: Optional[float] = None):
        """Block until resolved, then return :meth:`result` (re-raising the
        operation's error). Raises ``TimeoutError`` if ``timeout`` elapses."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout):
                raise TimeoutError(
                    f"operation did not complete within {timeout}s")
        return self.result()

    def result(self):
        if not self._done:
            raise RuntimeError("future not resolved; drive the cluster loop")
        if self._error is not None:
            raise self._error
        return self._result

    # ----------------------------------------------------------- dataflow
    def then(self, fn: Callable[[Any], Any]) -> "Future":
        """Chain: a future resolving to ``fn(self.result())``.

        If this future errors, the error propagates and ``fn`` never runs;
        if ``fn`` raises, the derived future carries that error. The derived
        future inherits this future's dataflow sources, so it can itself be
        passed as an op argument (the Router gates on the same source ops).
        """
        child = Future(sources=self.sources)

        def _link(parent: "Future"):
            if parent._error is not None:
                child.set_error(parent._error)
                return
            try:
                child.set_result(fn(parent._result))
            except Exception as e:  # noqa: BLE001 - user transform error
                child.set_error(e)

        self.add_done_callback(_link)
        return child


def gather(*futures: Future) -> Future:
    """Join futures into one resolving to ``[f.result(), ...]`` in argument
    order; the first error wins (later results are dropped). The joined
    future's sources are the union of the inputs' sources, so it composes
    with future-argument splicing like any other future."""
    futures = tuple(futures)
    sources: Tuple[int, ...] = tuple(
        dict.fromkeys(s for f in futures for s in f.sources))
    joined = Future(sources=sources)
    if not futures:
        joined.set_result([])
        return joined
    lock = threading.Lock()
    remaining = [len(futures)]
    fired = [False]
    results: List[Any] = [None] * len(futures)

    def _arm(i: int, f: Future):
        def _done(fut: Future):
            with lock:
                if fired[0]:
                    return
                if fut._error is not None:
                    err, fire = fut._error, "error"
                    fired[0] = True
                else:
                    results[i] = fut._result
                    remaining[0] -= 1
                    if remaining[0]:
                        return
                    fire = "result"
                    fired[0] = True
            # fire outside the counting lock (callbacks may submit ops)
            if fire == "error":
                joined.set_error(err)
            else:
                joined.set_result(list(results))
        f.add_done_callback(_done)

    for i, f in enumerate(futures):
        _arm(i, f)
    return joined


_req_counter = itertools.count(1)


# Containers are searched/spliced _MAX_ARG_DEPTH levels below each
# top-level argument value. The two walks MUST agree: every future the
# splice can reach must also have been seen by the prerequisite scan,
# otherwise dispatch would block on an ungated future.
_MAX_ARG_DEPTH = 3

# Upper bound on the dispatch-time wait for a future argument whose source
# ops already COMPLETED: it covers the client-side `.then` transform chain
# still running on the resolving thread (packing a large rollout batch can
# take real time), NOT the ops themselves — those are gated by
# prerequisites. Module-level so deployments with pathological transforms
# can raise it.
SPLICE_TIMEOUT_S = 600.0


def _walk_futures(obj, found: List[Future], depth: int = 0):
    """Collect Future instances from an argument value and its containers
    (lists, tuples, dicts) up to ``_MAX_ARG_DEPTH`` levels deep — deep
    enough for every realistic op signature without touching tensor
    payloads. Mirrors :func:`_splice` exactly."""
    if isinstance(obj, Future):
        found.append(obj)
        return
    if depth >= _MAX_ARG_DEPTH:
        return
    if isinstance(obj, (list, tuple)):
        for v in obj:
            _walk_futures(v, found, depth + 1)
    elif isinstance(obj, dict):
        for v in obj.values():
            _walk_futures(v, found, depth + 1)


def _splice(obj, depth: int = 0, timeout: Optional[float] = None):
    """Replace embedded futures with their resolved values (dispatch-time
    argument substitution; mirrors :func:`_walk_futures`). The futures'
    source ops are COMPLETED by the time the dependent op is dispatched, so
    the bounded wait only bridges the instant between a source's state
    transition and its callback chain; a future that errored re-raises
    here, failing (and thus poisoning) the dependent op."""
    if isinstance(obj, Future):
        return obj.wait(timeout=SPLICE_TIMEOUT_S if timeout is None
                        else timeout)
    if depth >= _MAX_ARG_DEPTH:
        return obj
    if isinstance(obj, list):
        return [_splice(v, depth + 1, timeout) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_splice(v, depth + 1, timeout) for v in obj)
    if isinstance(obj, dict):
        return {k: _splice(v, depth + 1, timeout) for k, v in obj.items()}
    return obj


@dataclasses.dataclass
class QueuedOperation:
    """submit_queued_operation wrapper (§5.2.2): request + future handle."""
    req_id: int
    deployment_id: str
    job_id: str
    op: Op
    args: tuple = ()
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    exec_estimate: float = 1.0
    arrival_time: float = 0.0
    future: Future = dataclasses.field(default_factory=Future)
    prerequisites: Tuple[int, ...] = ()
    has_future_args: bool = False
    # set by Router.teardown for an op already RUNNING when its deployment
    # detaches: the execution backend, pinned so the op still completes
    # normally after the router's wpg table entry is gone
    pinned_wpg: Any = None

    def resolve_args(self):
        """Dispatch-time dataflow splice: substitute resolved values for any
        future passed as an argument. Mutates in place (each op dispatches
        exactly once)."""
        if not self.has_future_args:
            return
        self.args = tuple(_splice(v) for v in self.args)
        self.kwargs = {k: _splice(v) for k, v in self.kwargs.items()}
        self.has_future_args = False


def make_op(deployment: DeploymentSpec, op: Op, *args,
            exec_estimate: float = 1.0, arrival_time: float = 0.0,
            prerequisites: Tuple[int, ...] = (), **kwargs) -> QueuedOperation:
    """Low-level constructor (escape hatch): builds one QueuedOperation.

    Futures embedded in ``args``/``kwargs`` are detected here: their source
    ops join ``prerequisites`` and the op is marked for dispatch-time
    splicing. ``prerequisites`` may also mix Futures with raw req_ids."""
    req_id = next(_req_counter)
    embedded: List[Future] = []
    # scan each top-level value from depth 0 so the reachable set is
    # IDENTICAL to resolve_args' splice (which substitutes per value)
    for v in args:
        _walk_futures(v, embedded)
    for v in kwargs.values():
        _walk_futures(v, embedded)
    prereqs: List[int] = []
    for p in prerequisites:
        if isinstance(p, Future):
            if not p.sources and not p.done():
                raise ValueError(
                    "ordering future has no source operations and is "
                    "unresolved: the scheduler cannot gate on it")
            prereqs.extend(p.sources)
        else:
            prereqs.append(p)
    for f in embedded:
        if not f.sources and not f.done():
            # no prerequisite can gate this op, so dispatch would block a
            # group's exclusive lock waiting on a hand-made future — refuse
            # loudly at submit time instead
            raise ValueError(
                "argument future has no source operations and is "
                "unresolved: resolve it first, or derive it from a "
                "Deployment op so admission can be gated on it")
        prereqs.extend(f.sources)
    # dedup, drop self-reference, preserve order
    prereqs = [p for p in dict.fromkeys(prereqs) if p != req_id]
    qop = QueuedOperation(
        req_id=req_id,
        deployment_id=deployment.deployment_id,
        job_id=deployment.job_id,
        op=op, args=args, kwargs=kwargs,
        exec_estimate=exec_estimate,
        arrival_time=arrival_time,
        prerequisites=tuple(prereqs),
        has_future_args=bool(embedded),
    )
    qop.future.sources = (req_id,)
    return qop


class Deployment:
    """Bound client handle: one logical deployment plus the router serving
    it. Every method submits one primitive operation and returns its
    :class:`Future` immediately (non-blocking, §5.2.2); the scheduler owns
    ordering via the dataflow edges described in the module docstring.

    ``after=`` takes futures (or raw req_ids) that must complete first even
    though their results are not consumed — the pure-ordering edge (e.g.
    one-step-async gating of generation k on update k-1-s).
    """

    def __init__(self, spec: DeploymentSpec, router):
        self.spec = spec
        self.router = router

    # ----------------------------------------------------------- plumbing
    @property
    def deployment_id(self) -> str:
        return self.spec.deployment_id

    @property
    def job_id(self) -> str:
        return self.spec.job_id

    @property
    def wpg(self):
        return self.router.wpgs[self.spec.deployment_id]

    def call(self, op: Op, *args, exec_estimate: float = 1.0,
             after: Tuple = (), **kwargs) -> Future:
        """Generic submit: any primitive op through the dataflow path."""
        qop = make_op(self.spec, op, *args, exec_estimate=exec_estimate,
                      prerequisites=tuple(after), **kwargs)
        return self.router.submit_queued_operation(qop)

    # ------------------------------------------------------ primitive ops
    def init(self, seed: int = 0, *, exec_estimate: float = 1.0,
             after: Tuple = ()) -> Future:
        return self.call(Op.INIT, seed, exec_estimate=exec_estimate,
                         after=after)

    def generate(self, prompt_tokens, *, max_new_tokens: int = 32,
                 temperature: float = 1.0, exec_estimate: float = 1.0,
                 after: Tuple = (), **kwargs) -> Future:
        return self.call(Op.GENERATE, prompt_tokens,
                         max_new_tokens=max_new_tokens,
                         temperature=temperature,
                         exec_estimate=exec_estimate, after=after, **kwargs)

    def forward(self, batch, *, output: str = "logprobs",
                exec_estimate: float = 1.0, after: Tuple = ()) -> Future:
        """Forward-only op; ``output`` picks the readout ("logprobs" for
        compute_log_prob, "values" for a critic deployment)."""
        return self.call(Op.FORWARD, batch, output=output,
                         exec_estimate=exec_estimate, after=after)

    def forward_backward(self, batch, *, objective: str = "grpo",
                         exec_estimate: float = 1.0,
                         after: Tuple = ()) -> Future:
        return self.call(Op.FORWARD_BACKWARD, batch, objective=objective,
                         exec_estimate=exec_estimate, after=after)

    def optim_step(self, grads, *, host: bool = False,
                   exec_estimate: float = 1.0, after: Tuple = ()) -> Future:
        return self.call(Op.OPTIM_STEP, grads, host=host,
                         exec_estimate=exec_estimate, after=after)

    def update_actor(self, batch, *, exec_estimate: float = 1.0,
                     after: Tuple = ()) -> Future:
        return self.call(Op.UPDATE_ACTOR, batch,
                         exec_estimate=exec_estimate, after=after)

    def sync_weights(self, target: "Deployment", *, target_shardings=None,
                     exec_estimate: float = 1.0, after: Tuple = ()) -> Future:
        tgt = target.wpg if isinstance(target, Deployment) else target
        return self.call(Op.SYNC_WEIGHTS, tgt,
                         target_shardings=target_shardings,
                         exec_estimate=exec_estimate, after=after)

    def save_checkpoint(self, path: str, step: int = 0, *,
                        exec_estimate: float = 1.0,
                        after: Tuple = ()) -> Future:
        return self.call(Op.SAVE_CHECKPOINT, path, step,
                         exec_estimate=exec_estimate, after=after)

    def load_checkpoint(self, path: str, *, exec_estimate: float = 1.0,
                        after: Tuple = ()) -> Future:
        return self.call(Op.LOAD_CHECKPOINT, path,
                         exec_estimate=exec_estimate, after=after)
