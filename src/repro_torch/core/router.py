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
  serving spawns that group's worker, and :meth:`teardown` cancels a
  departing deployment's queued operations.
- :meth:`run_until_idle` — a bounded session of the same worker loop.
- :meth:`step` / :meth:`drain` — the serial driver on the same path.

The control methods that ``PlexCluster`` and the ``PlacementDirector``
call are the reference's: group lifecycle (:meth:`ensure_group`,
:meth:`retire_group`), telemetry, tenant binding, and live re-placement
(:meth:`reassign_job` → :meth:`migrate_job` → ``StateManager.migrate``).
Groups that lease the same device (every group on one H100) run their
dispatch threads at once on that device, as the reference does on one
device. With ``process_plane=True`` each node group's WPGs live in their
own spawned worker process (:mod:`repro_torch.launch.proc_plane`), which
the Router supervises (:meth:`process_health`, :meth:`respawn_dead_groups`,
:meth:`close_processes`). ``devices_per_group`` sizes the slices the
plane leases (``DevicePlane(slice_size=)``); a group whose slice has
several devices runs its WPGs tensor-parallel over it, in this process or,
in process mode, in its child, which sees the slice's devices.

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
from repro_torch.launch.mesh import (DevicePlane, devices_for_slice,
                                     env_for_slice)
from repro_torch.launch.proc_plane import (GroupProcess, StateManagerProxy,
                                           WPGProxy)

logger = logging.getLogger(__name__)


class Router:
    def __init__(self, now: Callable[[], float] = time.monotonic,
                 policy: str = "hrrs",
                 wpg_factory: Callable[..., object] = WorkerProcessGroup,
                 device_plane: Optional[DevicePlane] = None,
                 devices_per_group: Optional[int] = None,
                 process_plane: bool = False,
                 proc_wpg_factory: Optional[str] = None,
                 shm_transport: Optional[bool] = None):
        """``device_plane`` leases each node group its device slice; the
        default plane carves the CUDA devices (and raises without one)
        into slices of ``devices_per_group`` devices. Given with a plane
        that has no slice size yet, ``devices_per_group`` sets it.

        ``process_plane=True`` hosts each node group's WPGs in a spawned
        OS process bound to the group's slice: dispatch crosses a pipe, and
        groups feed their devices from separate interpreters.
        ``proc_wpg_factory`` names the child's WPG factory as
        "module:callable" (None: the real WorkerProcessGroup).
        ``shm_transport`` picks the shared-memory tensor transport (None:
        where the host supports it; False: the pickle path)."""
        self.now = now
        self.process_plane = process_plane
        self.proc_wpg_factory = proc_wpg_factory
        self.shm_transport = shm_transport
        self.group_procs: Dict[int, GroupProcess] = {}
        self.wpgs: Dict[str, object] = {}
        self.deployments: Dict[str, api.DeploymentSpec] = {}
        self.group_of: Dict[str, int] = {}       # deployment -> node group
        self.state_managers: Dict[int, StateManager] = {}
        if device_plane is None:
            device_plane = DevicePlane(slice_size=devices_per_group)
        elif devices_per_group is not None:
            if device_plane.slice_size is None and \
                    device_plane.domains() == {}:
                device_plane.slice_size = devices_per_group
            elif device_plane.slice_size != devices_per_group:
                raise ValueError(
                    f"devices_per_group {devices_per_group} against the "
                    f"plane's slice_size {device_plane.slice_size}")
        self.device_plane = device_plane
        # realized migration costs, drained by the PlacementDirector to
        # calibrate its migration-cost floor
        self.migrate_log: List[dict] = []
        self.executor = TaskExecutor(now=now, policy=policy)
        # per-job tenant binding and HRRS priority weight; 1.0 (the
        # default) leaves the score unchanged
        self.job_priority: Dict[str, float] = {}
        self.job_tenant: Dict[str, str] = {}
        # set by PlexCluster; tenant_telemetry() merges its snapshot
        self.tenant_ledger = None
        # dispatch workers abandoned while hung in wpg.execute
        self._abandoned: List[threading.Thread] = []
        # per-job queued-op table, keyed by req_id for O(1) finalize
        self.request_queues: Dict[str, Dict[int, api.QueuedOperation]] = {}
        self.pending: Dict[int, api.QueuedOperation] = {}
        self.switch_log: List[dict] = []
        self.wpg_factory = wpg_factory
        # exceptions raised by user callbacks during future resolution; a
        # broken callback must not kill a dispatch thread mid-protocol
        self.callback_errors: List[Tuple[int, BaseException]] = []
        # serve plane: one stop token per group worker (so retire_group can
        # stop one) and the plane-wide shutdown token
        self._serving = False
        self._serve_stop = threading.Event()
        self._serve_stops: Dict[int, threading.Event] = {}
        self._serve_threads: Dict[int, threading.Thread] = {}
        self._serve_executed: Dict[int, List[int]] = {}
        self._serve_err_start = 0

    # ----------------------------------------------------------- lifecycle
    def _group_sm(self, group_id: int) -> StateManager:
        """The group's StateManager, created (with the group's device slice
        leased from the plane) on first sight. In process mode first sight
        spawns the group's worker process (the ready handshake is awaited
        on first use) and the StateManager is a
        :class:`~repro_torch.launch.proc_plane.StateManagerProxy` over its
        pipe."""
        sm = self.state_managers.get(group_id)
        if sm is None:
            sl = self.device_plane.slice_for_group(group_id)
            if self.process_plane:
                sm = self._spawn_group_process(group_id, sl)
            else:
                sm = StateManager(node_id=f"group{group_id}", clock=self.now,
                                  mesh_slice=sl)
            self.state_managers[group_id] = sm
        return sm

    def _spawn_group_process(self, group_id: int, sl) -> StateManagerProxy:
        """The group's child on its slice: it sees the slice's cards and
        builds the slice (the same device ids) over them. The proxy keeps
        the parent's slice."""
        gp = GroupProcess(group_id, env=env_for_slice(sl),
                          slice_index=sl.index,
                          wpg_factory=self.proc_wpg_factory,
                          node_id=f"group{group_id}",
                          shm=self.shm_transport,
                          devices=devices_for_slice(sl),
                          device_ids=list(sl.device_ids()))
        self.group_procs[group_id] = gp
        return StateManagerProxy(gp, mesh_slice=sl,
                                 node_id=f"group{group_id}")

    def mesh_domains(self) -> Dict[int, int]:
        """group id -> slice index (the placement layer's domain map: a
        move between different domains pays the cross-device copy)."""
        return self.device_plane.domains()

    def create_deployment(self, spec: api.DeploymentSpec, group_id: int = 0):
        """Register a deployment (low level; returns the WPG). While serving,
        a deployment on a group without a dispatch worker spawns one."""
        with self.executor.cv:
            sm = self._group_sm(group_id)
        # built OUTSIDE the cv: a slow model build (or the child's
        # create_deployment round trip) must not stall dispatch
        wpg = WPGProxy(spec, sm) if self.process_plane \
            else self.wpg_factory(spec, sm)
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

    def teardown(self, deployment_id: str):
        """Detach a deployment from the (possibly live) plane.

        Its queued operations are cancelled: each resolves its future with a
        teardown error, and anything depending on them is poisoned through
        the normal failure path. An operation already RUNNING completes and
        resolves its future normally, and its managed state is dropped once
        it has. The job's request queue is dropped once its last deployment
        detaches."""
        cancelled: List[Tuple[api.QueuedOperation, Exception]] = []
        ex = self.executor
        with ex.cv:
            wpg = self.wpgs.pop(deployment_id, None)
            spec = self.deployments.pop(deployment_id, None)
            self.group_of.pop(deployment_id, None)
            if spec is not None:
                err = RuntimeError(f"deployment {deployment_id} torn down")
                for qop in list(self.pending.values()):
                    if qop.deployment_id != deployment_id:
                        continue
                    task = ex.tasks.get(qop.req_id)
                    if task is None or task.state != State.QUEUED:
                        # RUNNING (possibly admitted but not yet executing):
                        # pin the backend so the op completes normally
                        qop.pinned_wpg = wpg
                        continue
                    ex.finish(task, error=str(err))
                    self._finalize(qop)
                    cancelled.append((qop, err))
                if not any(s.job_id == spec.job_id
                           for s in self.deployments.values()):
                    self.request_queues.pop(spec.job_id, None)
                    self.job_priority.pop(spec.job_id, None)
                    self.job_tenant.pop(spec.job_id, None)
            if cancelled:
                # hold the idle guard across the error callbacks below (a
                # callback may resubmit; same protocol as _reap_and_resolve)
                ex.inflight += 1
        if wpg is not None:
            # an op pinned mid-execute still reads this deployment's state:
            # let it drain before the entries are dropped (bounded; submits
            # to the torn-down deployment are refused, so its pending ops
            # can only shrink)
            with ex.cv:
                ex.cv.wait_for(
                    lambda: not any(q.deployment_id == deployment_id
                                    for q in self.pending.values()),
                    timeout=120.0)
            wpg.sm.unregister(wpg.sm.keys_for(wpg.job_prefix))
            close = getattr(wpg, "close", None)
            if close is not None:       # process mode: drop the child's WPG
                close()
        if cancelled:
            try:
                for qop, err in cancelled:
                    self._resolve_future(qop, None, err)
            finally:
                with ex.cv:
                    ex.inflight -= 1
                    ex.cv.notify_all()

    # -------------------------------------------------------------- submit
    def register_job_tenant(self, job_id: str, tenant_id: str,
                            priority: float = 1.0):
        """Bind a job to its tenant and HRRS priority weight (1.0 leaves the
        score unchanged). Cleared when the job's last deployment
        detaches."""
        with self.executor.cv:
            self.job_tenant[job_id] = tenant_id
            self.job_priority[job_id] = priority

    def submit_queued_operation(self, qop: api.QueuedOperation) -> api.Future:
        """Non-blocking API handler (§5.2.2): wrap + enqueue, return at once.
        Thread-safe: callbacks submit follow-ups from dispatch threads."""
        with self.executor.cv:
            if qop.deployment_id not in self.group_of:
                raise RuntimeError(
                    f"unknown deployment {qop.deployment_id!r} "
                    "(never created, or torn down)")
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
        moved = dict(sm.bytes_moved)
        t_off = 0.0
        for w in resident:
            t_off += w.offload()
        t_load = target_wpg.ensure_resident()
        if resident or t_load > 0:
            with self.executor.cv:
                self.switch_log.append({
                    "t": self.now(), "group": group_id, "to_job": qop.job_id,
                    "t_offload": t_off, "t_load": t_load,
                    "offload_bytes": sm.bytes_moved["offload"]
                    - moved["offload"],
                    "load_bytes": sm.bytes_moved["load"] - moved["load"]})
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
            # an op RUNNING when its deployment tore down keeps executing on
            # the pinned backend, so it still completes (and bills) normally
            wpg = self.wpgs.get(qop.deployment_id) or qop.pinned_wpg
        result, err = None, None
        try:
            qop.resolve_args()
            if wpg is None:
                raise RuntimeError(
                    f"deployment {qop.deployment_id} torn down")
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
            stop = self._serve_stops[group_id] = threading.Event()
            t = threading.Thread(
                target=self._worker_loop,
                args=(group_id, stop, True, counter, 0),
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
            self._serve_stops = {}
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
            for stop in self._serve_stops.values():
                stop.set()
            self.executor.cv.notify_all()
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in self._serve_threads.values():
            t.join(timeout=None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
        leaked = [t for t in self._serve_threads.values() if t.is_alive()]
        with self.executor.cv:
            self._serving = False
            self._serve_threads = {}
            self._serve_stops = {}
            self._abandoned.extend(leaked)
        for t in leaked:
            logger.warning("serve worker %s still hung in execute at "
                           "shutdown; abandoned as a daemon (see "
                           "abandoned_workers())", t.name)
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

    def abandoned_workers(self) -> List[str]:
        """Names of dispatch workers abandoned while hung in ``execute``
        (the threads are daemons and exit when their op returns; entries
        prune themselves here)."""
        with self.executor.cv:
            self._abandoned = [t for t in self._abandoned if t.is_alive()]
            return [t.name for t in self._abandoned]

    # ------------------------------------------------------- process plane
    def process_health(self) -> Dict[int, bool]:
        """group id -> worker-process liveness (process mode; empty in
        thread mode)."""
        return {gid: gp.alive() for gid, gp in self.group_procs.items()}

    def respawn_dead_groups(self) -> List[int]:
        """Respawn every dead group worker process in place (deployments
        replayed, managed state lost: a device failure). The director's
        capacity adjuster calls this each poll; a no-op in thread mode.
        Each respawn first reaps the dead incarnation's shm segments and
        its orphaned ``export__*`` spill files. Returns the group ids."""
        respawned: List[int] = []
        for gid, gp in list(self.group_procs.items()):
            if not gp.alive():
                logger.warning("group %d worker process died (exitcode %s); "
                               "respawning", gid,
                               None if gp._proc is None else gp._proc.exitcode)
                gp.respawn()
                respawned.append(gid)
        return respawned

    def close_processes(self, timeout: float = 10.0):
        """Shut down every group worker process (protocol shutdown,
        escalating to terminate). The children are daemons, so an unclosed
        plane still dies with the parent."""
        for gp in self.group_procs.values():
            gp.shutdown(timeout=timeout)
        self.group_procs.clear()

    # ------------------------------------------- group lifecycle / telemetry
    def known_groups(self) -> List[int]:
        with self.executor.cv:
            return sorted(set(self.group_of.values())
                          | set(self.state_managers)
                          | set(self._serve_threads))

    def ensure_group(self, group_id: int) -> StateManager:
        """Register a node group with the control plane (a capacity
        spawn, §4.4): its StateManager exists from here on, and while
        serving a dispatch worker is spawned for it."""
        with self.executor.cv:
            sm = self._group_sm(group_id)
            serving = self._serving
        if serving:
            self._ensure_serve_worker(group_id)
        return sm

    def retire_group(self, group_id: int, timeout: float = 30.0):
        """Capacity-adjustment retire: stop one group's dispatch worker,
        forget its scheduling state and return its device lease. Refuses
        while the group still hosts deployments or open tasks."""
        ex = self.executor
        with ex.cv:
            live = [d for d, g in self.group_of.items() if g == group_id]
            if live:
                raise RuntimeError(
                    f"group {group_id} still hosts deployments {live}")
            stuck = [t.request.req_id for t in ex.tasks.values()
                     if t.group_id == group_id
                     and t.state in (State.QUEUED, State.RUNNING)]
            if stuck:
                raise RuntimeError(
                    f"group {group_id} still has open tasks {stuck}")
            t = self._serve_threads.pop(group_id, None)
            stop = self._serve_stops.pop(group_id, None)
            if stop is not None:
                stop.set()
            ex.cv.notify_all()
        if t is not None:
            t.join(timeout=timeout)
            if t.is_alive():
                raise RuntimeError(
                    f"group {group_id} worker did not exit in {timeout}s")
        try:
            ex.drop_group(group_id)
        except RuntimeError:
            # an attach raced the retire and submitted work: put the
            # dispatch worker back so the new deployment is not stranded
            if self._serving:
                self._ensure_serve_worker(group_id)
            raise
        gp = None
        with ex.cv:
            # an attach that raced past drop_group owns the group again:
            # leave its (empty) StateManager alone
            if not any(g == group_id for g in self.group_of.values()):
                sm = self.state_managers.get(group_id)
                if sm is not None and not sm.entries:
                    del self.state_managers[group_id]
                    self.device_plane.release(group_id)
                    gp = self.group_procs.pop(group_id, None)
        if gp is not None:          # outside the cv: shutdown joins the child
            gp.shutdown()

    def group_telemetry(self) -> Dict[int, dict]:
        """Per-group queue depth and occupancy (the §4.4 capacity
        adjuster's input): queue_depth (QUEUED ops), running (an op holds
        the group lock), busy_seconds (measured execution), resident_job,
        deployments, worker (a live serve thread), and in process mode
        process_alive."""
        ex = self.executor
        with ex.cv:
            groups = (set(self.group_of.values()) | set(self.state_managers)
                      | set(self._serve_threads))
            out: Dict[int, dict] = {}
            for g in sorted(groups):
                lock = ex.locks.get(g)
                out[g] = {
                    "queue_depth": ex.queued_count.get(g, 0),
                    "running": bool(lock and lock.holder is not None),
                    "busy_seconds": ex.group_busy.get(g, 0.0),
                    "resident_job": ex.resident_job.get(g),
                    "deployments": sorted(
                        d for d, gg in self.group_of.items() if gg == g),
                    "worker": g in self._serve_threads,
                }
        if self.process_plane:
            for g, d in out.items():
                gp = self.group_procs.get(g)
                d["process_alive"] = bool(gp is not None and gp.alive())
        return out

    def tenant_telemetry(self) -> Dict[str, dict]:
        """Per-tenant snapshot beside :meth:`group_telemetry`:
        queue_depth, running, jobs and groups from the plane, merged with
        the :class:`~repro_torch.core.tenancy.TenantLedger`'s accounting
        (gpu_seconds, steps_total, slo_attainment, step_p95_s,
        pending_jobs) where one is wired."""
        ex = self.executor
        out: Dict[str, dict] = {}

        def slot(tenant: str) -> dict:
            return out.setdefault(tenant, {
                "queue_depth": 0, "running": 0,
                "jobs": set(), "groups": set()})

        with ex.cv:
            for t in ex.tasks.values():
                if t.state not in (State.QUEUED, State.RUNNING):
                    continue
                s = slot(self.job_tenant.get(t.request.job_id, "default"))
                if t.state == State.QUEUED:
                    s["queue_depth"] += 1
                else:
                    s["running"] += 1
            for dep_id, spec in self.deployments.items():
                s = slot(self.job_tenant.get(spec.job_id, "default"))
                s["jobs"].add(spec.job_id)
                s["groups"].add(self.group_of[dep_id])
            for job_id, tenant in self.job_tenant.items():
                slot(tenant)["jobs"].add(job_id)
        if self.tenant_ledger is not None:
            for tenant, acct in self.tenant_ledger.snapshot().items():
                slot(tenant).update(acct)
        for s in out.values():
            s["jobs"] = sorted(s["jobs"])
            s["groups"] = sorted(s["groups"])
        return out

    # ------------------------------------------------- elastic re-placement
    def migrate_job(self, job_id: str, src_group: int, dst_group: int) -> int:
        """Move a job's managed state across groups (§4.5.3). Callers
        quiesce and hold the job first (:meth:`reassign_job`). The move
        runs outside the executor lock, so other groups keep dispatching;
        only the map swaps take it. The realized cost is appended to
        :attr:`migrate_log`."""
        with self.executor.cv:
            src = self.state_managers[src_group]
            dst = self._group_sm(dst_group)
            targets = [(d, w) for d, w in self.wpgs.items()
                       if w.spec.job_id == job_id]
        t0 = self.now()
        moved = 0
        cross = False
        for _, wpg in targets:
            moved += src.migrate(wpg.job_prefix, dst)
            cross = cross or bool(src.last_migrate["cross_mesh"])
        dt = self.now() - t0
        with self.executor.cv:
            for dep_id, wpg in targets:
                wpg.sm = dst
                self.group_of[dep_id] = dst_group
            if self.executor.resident_job.get(src_group) == job_id:
                self.executor.resident_job[src_group] = None
            self.migrate_log.append({
                "job": job_id, "src": src_group, "dst": dst_group,
                "bytes": moved, "seconds": dt, "cross_mesh": cross,
                "t": self.now()})
            if len(self.migrate_log) > 1024:
                del self.migrate_log[:len(self.migrate_log) - 1024]
        return moved

    def reassign_job(self, job_id: str, dst_group: int,
                     timeout: float = 120.0) -> int:
        """Realize a re-placement against the live plane: hold the job's
        admissions, wait for its RUNNING ops to drain, migrate its state,
        re-home its queued ops onto ``dst_group``, release. Billing stays
        continuous: the exec logs live on the WPGs, which survive."""
        ex = self.executor
        ex.hold_job(job_id)
        try:
            with ex.cv:
                ok = ex.cv.wait_for(lambda: not ex.job_running(job_id),
                                    timeout)
            if not ok:
                raise TimeoutError(
                    f"job {job_id} did not quiesce within {timeout}s")
            with ex.cv:
                src_groups = {g for d, g in self.group_of.items()
                              if self.deployments[d].job_id == job_id}
            moved = 0
            for src in src_groups:
                if src != dst_group:
                    moved += self.migrate_job(job_id, src, dst_group)
            if self._serving:
                self._ensure_serve_worker(dst_group)
            ex.rehome_job(job_id, dst_group)
        finally:
            ex.release_job(job_id)
        return moved

    def reassign_jobs(self, moves, timeout: float = 120.0) -> List[tuple]:
        """Realize a batch of moves (the §4.3.2 repack loop's output), each
        through :meth:`reassign_job`, moves out of a group before moves
        into it; a cycle is broken at the lowest job id. A failing move is
        captured in its slot and the rest still run. Returns ``(move,
        moved_bytes, error)`` in execution order; a move is anything with
        ``job_id`` / ``src_group`` / ``dst_group``."""
        remaining = sorted(moves, key=lambda m: m.job_id)
        ordered = []
        while remaining:
            pick = next((m for m in remaining
                         if not any(o.src_group == m.dst_group
                                    for o in remaining if o is not m)),
                        remaining[0])
            remaining.remove(pick)
            ordered.append(pick)
        results: List[tuple] = []
        for m in ordered:
            try:
                moved = self.reassign_job(m.job_id, m.dst_group,
                                          timeout=timeout)
                results.append((m, moved, None))
            except Exception as e:  # noqa: BLE001 - per-move isolation
                results.append((m, 0, e))
        return results

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
                    with ex.cv:
                        self._abandoned.append(t)
                    logger.warning("dispatch worker %s hung in execute past "
                                   "the abandon grace; leaked as a daemon "
                                   "(see abandoned_workers())", t.name)
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
