"""Stateless Router: control-plane entry point of the execution service.

§5.1: the Router maps logical deployment ids to WPGs, submits every incoming
operation to the Scheduler for admission, and only then dispatches it. It
owns deployment creation and the automatic context switch of §5.2.2
(``_handle_job_transition``): when an admitted operation targets a different
job than the one resident on the target group, offload + load run first and
their measured times recalibrate HRRS's setup costs.

This is the in-process (threaded) plane of ``repro.core.router``, on the
same admission path (HRRS scoring + lock-gated start in ``TaskExecutor``):

- :meth:`serve` / :meth:`shutdown` — one dispatch worker thread per node
  group parks on the executor's condition variable and admits work the
  moment it arrives; :meth:`create_deployment` on a new group while
  serving spawns that group's worker.
- :meth:`run_until_idle` — a bounded session of the same worker loop.
- :meth:`step` / :meth:`drain` — the serial driver on the same path.

Futures passed as operation arguments are dataflow edges (see
:mod:`repro_torch.core.api`); an operation that raises resolves its future
with the error and poisons its queued dependents, so every driver
terminates.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import api
from repro_torch.core.scheduler import hrrs
from repro_torch.core.scheduler.executor import State, Task, TaskExecutor
from repro_torch.core.state_manager import StateManager
from repro_torch.core.worker import WorkerProcessGroup
from repro_torch.launch.mesh import DevicePlane

logger = logging.getLogger(__name__)


class Router:
    def __init__(self, now: Callable[[], float] = time.monotonic,
                 policy: str = "hrrs",
                 wpg_factory: Callable[..., object] = WorkerProcessGroup,
                 device_plane: Optional[DevicePlane] = None):
        """``device_plane`` leases each node group its device slice; the
        default plane carves the CUDA devices (and raises without one)."""
        self.now = now
        self.wpgs: Dict[str, object] = {}
        self.deployments: Dict[str, api.DeploymentSpec] = {}
        self.group_of: Dict[str, int] = {}       # deployment -> node group
        self.state_managers: Dict[int, StateManager] = {}
        self.device_plane = device_plane or DevicePlane()
        self.executor = TaskExecutor(now=now, policy=policy)
        # HRRS priority weight per job; 1.0 (the default) leaves the score
        # unchanged
        self.job_priority: Dict[str, float] = {}
        # per-job queued-op table, keyed by req_id for O(1) finalize
        self.request_queues: Dict[str, Dict[int, api.QueuedOperation]] = {}
        self.pending: Dict[int, api.QueuedOperation] = {}
        self.switch_log: List[dict] = []
        self.wpg_factory = wpg_factory
        # exceptions raised by user callbacks during future resolution; a
        # broken callback must not kill a dispatch thread mid-protocol
        self.callback_errors: List[Tuple[int, BaseException]] = []
        self._serving = False
        self._serve_stop = threading.Event()
        self._serve_threads: Dict[int, threading.Thread] = {}
        self._serve_executed: Dict[int, List[int]] = {}
        self._serve_err_start = 0

    # ----------------------------------------------------------- lifecycle
    def _group_sm(self, group_id: int) -> StateManager:
        """The group's StateManager, created (with the group's device slice
        leased from the plane) on first sight."""
        sm = self.state_managers.get(group_id)
        if sm is None:
            sm = StateManager(node_id=f"group{group_id}", clock=self.now,
                              mesh_slice=self.device_plane.slice_for_group(
                                  group_id))
            self.state_managers[group_id] = sm
        return sm

    def create_deployment(self, spec: api.DeploymentSpec, group_id: int = 0):
        """Register a deployment (low level; returns the WPG). While serving,
        a deployment on a group without a dispatch worker spawns one."""
        with self.executor.cv:
            sm = self._group_sm(group_id)
        # built OUTSIDE the cv: a slow model build must not stall dispatch
        wpg = self.wpg_factory(spec, sm)
        with self.executor.cv:
            self.wpgs[spec.deployment_id] = wpg
            self.deployments[spec.deployment_id] = spec
            self.group_of[spec.deployment_id] = group_id
            self.request_queues.setdefault(spec.job_id, {})
            serving = self._serving
        if serving:
            self._ensure_serve_worker(group_id)
        return wpg

    def deploy(self, spec: api.DeploymentSpec, group_id: int = 0
               ) -> api.Deployment:
        """Client-facing attach: register the deployment and return its bound
        :class:`~repro_torch.core.api.Deployment` handle."""
        self.create_deployment(spec, group_id=group_id)
        return api.Deployment(spec, self)

    # -------------------------------------------------------------- submit
    def submit_queued_operation(self, qop: api.QueuedOperation) -> api.Future:
        """Non-blocking API handler (§5.2.2): wrap + enqueue, return at once.
        Thread-safe: callbacks submit follow-ups from dispatch threads."""
        with self.executor.cv:
            if qop.deployment_id not in self.group_of:
                raise RuntimeError(
                    f"unknown deployment {qop.deployment_id!r}")
            qop.arrival_time = self.now()
            self.request_queues.setdefault(qop.job_id, {})[qop.req_id] = qop
            req = hrrs.Request(req_id=qop.req_id, job_id=qop.job_id,
                               op=qop.op.value, exec_time=qop.exec_estimate,
                               arrival_time=qop.arrival_time, payload=qop,
                               priority=self.job_priority.get(qop.job_id, 1.0))
            self.executor.submit(req, self.group_of[qop.deployment_id],
                                 prerequisites=qop.prerequisites)
            self.pending[qop.req_id] = qop
        return qop.future

    # ------------------------------------------------------------ dispatch
    def _handle_job_transition(self, group_id: int, qop: api.QueuedOperation,
                               target_wpg):
        """Automatic context switching: if the group's resident job differs,
        offload it, then load the target."""
        sm = self.state_managers[group_id]
        with self.executor.cv:
            resident = [w for d, g in self.group_of.items()
                        if g == group_id and d != qop.deployment_id
                        and (w := self.wpgs.get(d)) is not None
                        and w.spec.job_id != qop.job_id]
        resident = [w for w in resident if w.resident()]
        t_off = 0.0
        for w in resident:
            t_off += w.offload()
        t_load = target_wpg.ensure_resident()
        if resident or t_load > 0:
            with self.executor.cv:
                self.switch_log.append({
                    "t": self.now(), "group": group_id, "to_job": qop.job_id,
                    "t_offload": t_off, "t_load": t_load})
        # feed measured setup costs back into HRRS
        nbytes = sm.job_bytes(target_wpg.job_prefix)
        self.executor.set_setup_costs(group_id,
                                      sm.load_time_estimate(nbytes),
                                      sm.offload_time_estimate(nbytes))

    def _resolve_future(self, qop: api.QueuedOperation, result,
                        err: Optional[BaseException]):
        try:
            if err is None:
                qop.future.set_result(result)
            else:
                qop.future.set_error(err)
        except Exception as cb_err:  # noqa: BLE001 - user callback bug
            logger.warning("callback for op %d raised: %r",
                           qop.req_id, cb_err)
            self.callback_errors.append((qop.req_id, cb_err))

    def _raise_callback_errors(self, since: int):
        """Drivers fail loudly at exit if a user callback raised: work it was
        about to submit silently never ran."""
        new = self.callback_errors[since:]
        if new:
            req_id, first = new[0]
            raise RuntimeError(
                f"{len(new)} future callback(s) raised during dispatch; "
                f"first: op {req_id} -> {first!r}") from first

    def _finalize(self, qop: api.QueuedOperation):
        """Drop bookkeeping for a finished request (must hold executor.cv)."""
        self.pending.pop(qop.req_id, None)
        queue = self.request_queues.get(qop.job_id)
        if queue is not None:
            queue.pop(qop.req_id, None)

    def _reap_poisoned(self) -> List[Tuple[api.QueuedOperation, Exception]]:
        """FAIL every queued task whose prerequisite FAILED (to fixpoint).
        Returns the (qop, error) pairs; callers fire the futures OUTSIDE the
        lock. Scans only after a failure event (``poison_dirty``)."""
        out: List[Tuple[api.QueuedOperation, Exception]] = []
        with self.executor.cv:
            if not self.executor.poison_dirty:
                return out
            changed = True
            while changed:
                changed = False
                for t in list(self.executor.tasks.values()):
                    if t.state != State.QUEUED:
                        continue
                    bad = self.executor.failed_prereqs(t)
                    if not bad:
                        continue
                    cause = self.executor.tasks[bad[0]].error
                    err = RuntimeError(
                        f"prerequisite op {bad[0]} failed: {cause}")
                    self.executor.finish(t, error=str(err))
                    qop = self.pending.get(t.request.req_id)
                    if qop is not None:
                        self._finalize(qop)
                        out.append((qop, err))
                    changed = True
            self.executor.poison_dirty = False
        return out

    def _reap_and_resolve(self) -> None:
        """Reap poisoned tasks and fire their error callbacks under the
        inflight guard, so no worker declares the plane idle while a
        callback may still resubmit."""
        ex = self.executor
        with ex.cv:
            poisoned = self._reap_poisoned()
            if not poisoned:
                return
            ex.inflight += 1
        try:
            for qop, err in poisoned:
                self._resolve_future(qop, None, err)
        finally:
            with ex.cv:
                ex.inflight -= 1
                ex.cv.notify_all()

    def _execute_admitted(self, group_id: int, task: Task) -> None:
        """Run one admitted (RUNNING) operation and resolve its future
        OUTSIDE the executor lock, so callbacks may submit follow-ups."""
        with self.executor.cv:
            qop = self.pending[task.request.req_id]
            wpg = self.wpgs.get(qop.deployment_id)
        result, err = None, None
        try:
            qop.resolve_args()
            if qop.op != api.Op.INIT:
                self._handle_job_transition(group_id, qop, wpg)
            result = wpg.execute(qop)
        except Exception as e:  # noqa: BLE001 - surface via future
            err = e
        with self.executor.cv:
            self.executor.finish(task, error=None if err is None else str(err))
            self._finalize(qop)
        self._resolve_future(qop, result, err)

    # ------------------------------------------------------ serial driver
    def step(self, max_ops: int = 1) -> int:
        """Serial driver on the shared admission path: admit + execute up to
        ``max_ops`` operations inline."""
        if self._serving:
            raise RuntimeError("serial driver unavailable while serve() "
                               "workers own the plane; shutdown() first")
        err_start = len(self.callback_errors)
        executed = 0
        for _ in range(max_ops):
            progressed = False
            for group_id in sorted(set(self.group_of.values())):
                self._reap_and_resolve()
                with self.executor.cv:
                    task = self.executor.pick_next(group_id)
                    started = (task is not None
                               and self.executor.try_start(task))
                if not started:
                    continue
                self._execute_admitted(group_id, task)
                executed += 1
                progressed = True
            if not progressed:
                break
        self._raise_callback_errors(err_start)
        return executed

    def drain(self, max_steps: int = 100_000) -> int:
        total = 0
        for _ in range(max_steps):
            n = self.step()
            if n == 0:
                break
            total += n
        return total

    # ------------------------------------------------ shared worker loop
    def _worker_loop(self, group_id: int, stop: threading.Event,
                     persistent: bool, executed: List[int], slot: int,
                     deadline: Optional[float] = None):
        """One node group's dispatch worker. Its only blocking point is an
        untimed wait on the executor's condition variable, which every
        state change notifies. ``persistent`` workers (serve mode) park when
        the plane is idle; bounded workers (run_until_idle) exit instead."""
        ex = self.executor
        while not stop.is_set():
            self._reap_and_resolve()
            task = None
            with ex.cv:
                if stop.is_set():
                    return
                t = ex.pick_next(group_id)
                if t is not None and ex.try_start(t):
                    ex.inflight += 1
                    task = t
                elif (not persistent and ex.outstanding() == 0
                        and ex.inflight == 0):
                    ex.cv.notify_all()
                    return
                else:
                    ex.cv.wait()
                    continue
            try:
                self._execute_admitted(group_id, task)
                executed[slot] += 1
            finally:
                with ex.cv:
                    ex.inflight -= 1
                    ex.cv.notify_all()
            if deadline is not None and time.monotonic() > deadline:
                stop.set()
                with ex.cv:
                    ex.cv.notify_all()

    # ------------------------------------------------------- serve plane
    def _ensure_serve_worker(self, group_id: int):
        with self.executor.cv:
            if not self._serving or self._serve_stop.is_set():
                return
            if group_id in self._serve_threads:
                return
            counter = self._serve_executed.setdefault(group_id, [0])
            t = threading.Thread(
                target=self._worker_loop,
                args=(group_id, self._serve_stop, True, counter, 0),
                name=f"serve-g{group_id}", daemon=True)
            self._serve_threads[group_id] = t
        t.start()

    def serve(self):
        """Start the persistent dispatch plane (one parked worker per node
        group). Returns at once; pair with :meth:`shutdown` or use the
        Router as a context manager."""
        with self.executor.cv:
            if self._serving:
                raise RuntimeError("already serving")
            self._serve_stop = threading.Event()
            self._serve_threads = {}
            self._serve_executed = {}
            self._serve_err_start = len(self.callback_errors)
            self._serving = True
            groups = sorted(set(self.group_of.values()))
        for g in groups:
            self._ensure_serve_worker(g)

    def shutdown(self, timeout: Optional[float] = None):
        """Stop the serve plane: parked workers exit at once; a worker
        mid-execute finishes its op first (bounded by ``timeout``, after
        which it is abandoned as a daemon). Raises if a callback raised."""
        if not self._serving:
            return
        with self.executor.cv:
            self._serve_stop.set()
            self.executor.cv.notify_all()
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in self._serve_threads.values():
            t.join(timeout=None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
        leaked = [t for t in self._serve_threads.values() if t.is_alive()]
        with self.executor.cv:
            self._serving = False
            self._serve_threads = {}
        for t in leaked:
            logger.warning("serve worker %s still hung in execute at "
                           "shutdown; abandoned as a daemon", t.name)
        self._raise_callback_errors(self._serve_err_start)

    def __enter__(self) -> "Router":
        self.serve()
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    @property
    def serving(self) -> bool:
        return self._serving

    def serve_executed(self) -> int:
        """Operations executed by the current/last serve plane."""
        return sum(c[0] for c in self._serve_executed.values())

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until nothing is queued, running, or firing callbacks.
        True once quiesced, False if ``timeout`` elapsed first."""
        ex = self.executor
        with ex.cv:
            return ex.cv.wait_for(
                lambda: ex.outstanding() == 0 and ex.inflight == 0, timeout)

    # -------------------------------------------------- bounded driver
    def run_until_idle(self, timeout: Optional[float] = None) -> int:
        """A bounded session of the dispatch plane: the serve loop, but
        workers exit once nothing is queued, running, or firing callbacks.
        Returns the number of operations executed; on ``timeout`` raises
        ``TimeoutError`` listing the stuck ops (a worker hung inside
        ``wpg.execute`` is abandoned after a 1 s grace)."""
        if self._serving:
            raise RuntimeError("run_until_idle unavailable while serve() "
                               "workers own the plane; shutdown() first")
        groups = sorted(set(self.group_of.values()))
        if not groups:
            return 0
        err_start = len(self.callback_errors)
        deadline = None if timeout is None else time.monotonic() + timeout
        executed = [0] * len(groups)
        timed_out = threading.Event()
        ex = self.executor
        threads = [threading.Thread(
            target=self._worker_loop,
            args=(g, timed_out, False, executed, i, deadline),
            name=f"dispatch-g{g}", daemon=True)
            for i, g in enumerate(groups)]
        for t in threads:
            t.start()
        for t in threads:
            while t.is_alive():
                if deadline is None:
                    t.join()
                    continue
                remaining = deadline - time.monotonic()
                if remaining > 0 and not timed_out.is_set():
                    t.join(timeout=remaining)
                    continue
                if not timed_out.is_set():
                    timed_out.set()
                    with ex.cv:
                        ex.cv.notify_all()
                t.join(timeout=max(0.0, deadline + 1.0 - time.monotonic()))
                if t.is_alive():
                    logger.warning("dispatch worker %s hung in execute past "
                                   "the abandon grace; leaked as a daemon",
                                   t.name)
                break
        if timed_out.is_set():
            with ex.cv:
                stuck = [t.request.req_id for t in ex.tasks.values()
                         if t.state in (State.QUEUED, State.RUNNING)]
            if stuck:
                raise TimeoutError(f"run_until_idle exceeded {timeout}s; "
                                   f"stuck ops: {stuck}")
        self._raise_callback_errors(err_start)
        return sum(executed)
