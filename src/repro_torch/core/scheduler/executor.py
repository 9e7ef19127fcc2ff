"""Task Executor: the Scheduler's operational backbone (paper §5.2.3).

A lightweight finite state machine per job/request with three mechanics:

- Priority-based Admission (QUEUED): the pending pool is scored with HRRS
  against current resource availability. The default ``hrrs`` policy keeps
  the pool in an incremental kinetic-tournament index
  (:mod:`~repro_torch.core.scheduler.admission_index`) updated on submit /
  finish / start / setup-recalibration, so ``pick_next`` is amortised
  O(log n) instead of a full O(n log n) re-score; ``pick_next_full`` is the
  unchanged Algorithm-1 oracle the index is property-tested against (and
  the path non-``hrrs`` policies use).
- Lock-Gated Execution (RUNNING): a request transitions to RUNNING only
  after prerequisites finish and the exclusive node-group lock is acquired.
- Lifecycle Teardown (COMPLETED): releases locks and unblocks successors.

The executor is time-source agnostic: a callable ``now()`` lets the SAME
admission path run under wall-clock dispatch (concurrent WPG worker
threads), the discrete-event simulator, or a :class:`VirtualClock` for
deterministic replay. All state transitions are guarded by one re-entrant
mutex whose condition variable (``cv``) doubles as the dispatch-plane wakeup
signal: submissions and completions notify it, so per-group dispatchers
block instead of polling.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import threading
from typing import Callable, Deque, Dict, List, Optional, Sequence

from repro_torch.core.scheduler import hrrs
from repro_torch.core.scheduler.admission_index import GroupAdmissionIndex


class State(enum.Enum):
    QUEUED = "QUEUED"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"


@dataclasses.dataclass
class Task:
    request: hrrs.Request
    group_id: int
    state: State = State.QUEUED
    prerequisites: tuple = ()          # req_ids that must COMPLETE first
    t_admitted: float = 0.0
    t_started: float = 0.0
    t_finished: float = 0.0
    error: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class PhaseRecord:
    """One completed operation's timing, exported for the online profiler
    (paper §4.3.2: the control plane folds these into a per-job JobTrace)."""
    seq: int                           # global monotonic completion ordinal
    op: str                            # api.Op value ("generate", ...)
    group_id: int
    t_started: float
    t_finished: float

    @property
    def duration(self) -> float:
        return self.t_finished - self.t_started


class VirtualClock:
    """Deterministic, manually-advanced time source.

    Drop-in for ``time.monotonic`` wherever a ``now()`` callable is taken
    (Router, TaskExecutor, simulator), so HRRS admission decisions — which
    depend on waits computed from ``now() - arrival_time`` — replay
    identically across runs regardless of host load.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"virtual clock cannot go backwards ({dt})")
        with self._lock:
            self._t += dt
            return self._t

    def __call__(self) -> float:
        return self.now()


class GroupLock:
    """Exclusive lock per training-services node group (model-swap safety)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.holder: Optional[int] = None

    def acquire(self, req_id: int) -> bool:
        ok = self._lock.acquire(blocking=False)
        if ok:
            self.holder = req_id
        return ok

    def release(self, req_id: int):
        if self.holder == req_id:
            self.holder = None
            self._lock.release()


class TaskExecutor:
    def __init__(self, now: Callable[[], float],
                 t_load: float = 0.0, t_offload: float = 0.0,
                 policy: str = "hrrs", use_admission_index: bool = True,
                 max_settled_tasks: int = 4096, phase_window: int = 256):
        self.now = now
        self.t_load = t_load
        self.t_offload = t_offload
        # admission fallbacks for groups with no measured switch yet; the
        # scalar attributes above drift to "most recently measured anywhere"
        # (telemetry) and must NOT leak into another group's scoring
        self._default_t_load = t_load
        self._default_t_offload = t_offload
        self.policy = policy
        self.tasks: Dict[int, Task] = {}
        self.locks: Dict[int, GroupLock] = {}
        self.resident_job: Dict[int, Optional[str]] = {}
        self.switch_count = 0
        # Per-group measured setup costs (concurrent groups switch
        # independently; a global scalar would race across dispatch threads).
        self.group_t_load: Dict[int, float] = {}
        self.group_t_offload: Dict[int, float] = {}
        # One mutex guards every transition; its condition variable is the
        # dispatch-plane wakeup: submit/finish notify, dispatchers wait.
        self.cv = threading.Condition(threading.RLock())
        self.inflight = 0              # ops started but futures not yet fired
        self._open = 0                 # tasks in QUEUED or RUNNING
        self.failed_count = 0          # lifetime FAILED transitions
        # True whenever some QUEUED task MAY have a failed prerequisite:
        # set on every FAILED transition and on submit-under-failed-prereq,
        # cleared by the router once a poison sweep reaches fixpoint — so a
        # long-lived serve plane pays the full-table reap scan per failure
        # EVENT, not per dispatch iteration forever after the first failure
        self.poison_dirty = False
        # Incremental admission index (hrrs policy only): membership is
        # exactly the runnable set — ready QUEUED tasks — maintained on
        # submit / finish / try_start instead of re-derived per admission.
        self.use_admission_index = use_admission_index and policy == "hrrs"
        self._indexes: Dict[int, GroupAdmissionIndex] = {}
        # prereq req_id -> dependents whose readiness flips when it settles
        self._dependents: Dict[int, List[int]] = {}
        # Bounded retention of settled Task records (telemetry): settled
        # req_ids enter a FIFO ring; beyond ``max_settled_tasks`` the oldest
        # are dropped from ``tasks`` so a week-long serve plane does not grow
        # memory without bound. FAILED records are pinned while a poison
        # sweep may still need their error (poison_dirty).
        self.max_settled_tasks = max_settled_tasks
        self._settled: Deque[int] = collections.deque()
        # FAILED records get their own ring of the same capacity: a late
        # dependent submitted against a pruned FAILED prerequisite would
        # lose its poisoning (unknown prereq ids count as satisfied), so
        # error records are retained for max_settled_tasks *failures*
        # rather than settles — still bounded, far longer-lived
        self._settled_failed: Deque[int] = collections.deque()
        # Per-job phase telemetry for the control plane's online profiler
        # (bounded per job; independent of Task retention).
        self.phase_window = phase_window
        self.phase_log: Dict[str, Deque[PhaseRecord]] = {}
        self._phase_seq = 0
        # Per-group REALIZED busy windows (seq, job_id, t_started,
        # t_finished), bounded per group: the reconciler overlaps these with
        # the plan's predicted windows so occupancy drift is measured, not
        # only predicted.
        self.group_busy_log: Dict[int, Deque[tuple]] = {}
        # Live per-group telemetry the capacity adjuster polls.
        self.queued_count: Dict[int, int] = {}
        self.group_busy: Dict[int, float] = {}
        # per-job RUNNING counter: the migration quiesce predicate is
        # re-evaluated on every cv notification, so it must be O(1)
        self._running_count: Dict[str, int] = {}
        # Jobs under a migration hold: their QUEUED ops are not admissible
        # until release (the drain half of elastic re-placement, §4.5.3).
        self.held_jobs: set = set()

    # -------------------------------------------------------------- index
    def _index_for(self, group_id: int) -> GroupAdmissionIndex:
        idx = self._indexes.get(group_id)
        if idx is None:
            t_load, t_offload = self.setup_costs(group_id)
            idx = self._indexes[group_id] = GroupAdmissionIndex(t_load,
                                                                t_offload)
        return idx

    def _index_insert(self, task: Task):
        r = task.request
        self._index_for(task.group_id).insert(
            r.req_id, r.job_id, r.arrival_time, r.exec_time, self.now(),
            r.priority)

    def _index_remove(self, task: Task):
        idx = self._indexes.get(task.group_id)
        if idx is not None:
            idx.remove(task.request.req_id, self.now())

    # ------------------------------------------------------------- submit
    def submit(self, request: hrrs.Request, group_id: int,
               prerequisites: Sequence[int] = ()) -> Task:
        with self.cv:
            t = Task(request=request, group_id=group_id,
                     prerequisites=tuple(prerequisites),
                     t_admitted=self.now())
            self.tasks[request.req_id] = t
            self.locks.setdefault(group_id, GroupLock())
            self.resident_job.setdefault(group_id, None)
            self._open += 1
            self.queued_count[group_id] = \
                self.queued_count.get(group_id, 0) + 1
            if any(p in self.tasks
                   and self.tasks[p].state == State.FAILED
                   for p in t.prerequisites):
                self.poison_dirty = True   # born poisoned: needs a sweep
            if self.use_admission_index:
                for p in t.prerequisites:
                    pt = self.tasks.get(p)
                    if pt is None or pt.state in (State.QUEUED,
                                                  State.RUNNING):
                        self._dependents.setdefault(p, []).append(
                            request.req_id)
                if self._ready(t):
                    self._index_insert(t)
                # a task counted "ready" only because this req_id was an
                # unknown prerequisite is no longer ready now that the
                # prerequisite exists and is QUEUED (matches _ready, which
                # ignores prereq ids it has never seen)
                for d in self._dependents.get(request.req_id, ()):
                    dt = self.tasks.get(d)
                    if (dt is not None and dt.state == State.QUEUED
                            and not self._ready(dt)):
                        self._index_remove(dt)
            self.cv.notify_all()
            return t

    # ---------------------------------------------------------- admission
    def _ready(self, t: Task) -> bool:
        return (t.state == State.QUEUED
                and t.request.job_id not in self.held_jobs
                and all(self.tasks[p].state == State.COMPLETED
                        for p in t.prerequisites if p in self.tasks))

    def failed_prereqs(self, t: Task) -> List[int]:
        return [p for p in t.prerequisites
                if p in self.tasks and self.tasks[p].state == State.FAILED]

    def runnable(self, group_id: int) -> List[Task]:
        with self.cv:
            return [t for t in self.tasks.values()
                    if t.group_id == group_id and self._ready(t)]

    def setup_costs(self, group_id: int) -> tuple:
        return (self.group_t_load.get(group_id, self._default_t_load),
                self.group_t_offload.get(group_id, self._default_t_offload))

    def set_setup_costs(self, group_id: int, t_load: float, t_offload: float):
        with self.cv:
            self.group_t_load[group_id] = t_load
            self.group_t_offload[group_id] = t_offload
            # keep the scalar view as "most recently measured" for telemetry
            self.t_load = t_load
            self.t_offload = t_offload
            idx = self._indexes.get(group_id)
            if idx is not None:
                idx.set_setup_costs(t_load, t_offload)

    def pick_next(self, group_id: int) -> Optional[Task]:
        """Scored admission for one group. Does not start the task.

        ``hrrs`` policy: O(log n) read of the incremental index — provably
        (property-tested) the same pick as :meth:`pick_next_full`. Other
        policies fall through to the full plan."""
        with self.cv:
            if not self.use_admission_index:
                return self.pick_next_full(group_id)
            idx = self._indexes.get(group_id)
            if idx is None or not len(idx):
                return None
            req_id = idx.pick(self.now(), self.resident_job.get(group_id))
            return None if req_id is None else self.tasks[req_id]

    def pick_next_full(self, group_id: int) -> Optional[Task]:
        """Algorithm 1's full re-score over the runnable pool: the reference
        admission path (and the oracle the index is tested against)."""
        with self.cv:
            cands = self.runnable(group_id)
            if not cands:
                return None
            sched = (hrrs.schedule if self.policy == "hrrs"
                     else hrrs.fcfs_schedule)
            t_load, t_offload = self.setup_costs(group_id)
            plan = sched(None, None, [t.request for t in cands], self.now(),
                         self.resident_job[group_id], t_load, t_offload)
            if not plan:
                return None
            first = plan[0].request
            return self.tasks[first.req_id]

    # -------------------------------------------------------------- start
    def try_start(self, task: Task) -> bool:
        """Lock-gated QUEUED -> RUNNING transition."""
        with self.cv:
            if not self._ready(task):
                return False
            lock = self.locks[task.group_id]
            if not lock.acquire(task.request.req_id):
                return False
            if self.resident_job[task.group_id] not in (None,
                                                        task.request.job_id):
                self.switch_count += 1
            self.resident_job[task.group_id] = task.request.job_id
            task.state = State.RUNNING
            task.t_started = self.now()
            self.queued_count[task.group_id] -= 1
            job = task.request.job_id
            self._running_count[job] = self._running_count.get(job, 0) + 1
            task.request.running = True
            task.request.remaining_time = task.request.exec_time
            if self.use_admission_index:
                self._index_remove(task)
            return True

    # ------------------------------------------------------------- finish
    def finish(self, task: Task, error: Optional[str] = None):
        with self.cv:
            was_open = task.state in (State.QUEUED, State.RUNNING)
            if task.state == State.QUEUED:
                self.queued_count[task.group_id] -= 1
            ran = task.state == State.RUNNING
            if ran:
                job = task.request.job_id
                left = self._running_count.get(job, 1) - 1
                if left <= 0:
                    self._running_count.pop(job, None)
                else:
                    self._running_count[job] = left
            task.state = State.FAILED if error else State.COMPLETED
            task.error = error
            task.t_finished = self.now()
            task.request.running = False
            if ran and not error:
                dt = task.t_finished - task.t_started
                self.group_busy[task.group_id] = \
                    self.group_busy.get(task.group_id, 0.0) + dt
                self._phase_seq += 1
                log = self.phase_log.get(task.request.job_id)
                if log is None:
                    log = self.phase_log[task.request.job_id] = \
                        collections.deque(maxlen=self.phase_window)
                log.append(PhaseRecord(self._phase_seq, task.request.op,
                                       task.group_id, task.t_started,
                                       task.t_finished))
                blog = self.group_busy_log.get(task.group_id)
                if blog is None:
                    blog = self.group_busy_log[task.group_id] = \
                        collections.deque(maxlen=self.phase_window)
                blog.append((self._phase_seq, task.request.job_id,
                             task.t_started, task.t_finished))
            # The Task record is kept for telemetry (states, timings), but
            # the operation payload (args may hold whole rollout batches) is
            # only reachable through the future from here on — retaining it
            # would grow memory without bound over long runs.
            task.request.payload = None
            self.locks[task.group_id].release(task.request.req_id)
            if was_open:
                self._open -= 1
            if error:
                self.failed_count += 1
                self.poison_dirty = True
            if self.use_admission_index:
                # poisoned-while-QUEUED tasks may still be indexed
                self._index_remove(task)
                deps = self._dependents.pop(task.request.req_id, None)
                if deps and not error:
                    for d in deps:
                        dt = self.tasks.get(d)
                        if (dt is not None and dt.state == State.QUEUED
                                and self._ready(dt)):
                            self._index_insert(dt)
                # scrub this task's own registrations under still-pending
                # prereqs (incl. forward-referenced ids that never arrived)
                # so _dependents stays bounded by open tasks
                for p in task.prerequisites:
                    waiters = self._dependents.get(p)
                    if waiters is not None:
                        try:
                            waiters.remove(task.request.req_id)
                        except ValueError:
                            pass
                        if not waiters:
                            del self._dependents[p]
            self._settled.append(task.request.req_id)
            self._prune_settled()
            self.cv.notify_all()

    def _prune_settled(self):
        """Age out the oldest settled Task records beyond the retention cap
        (must hold cv). A FAILED record is pinned while a poison sweep may
        still need its error (``poison_dirty``); once swept it moves to the
        failed ring, which evicts per-failure rather than per-settle."""
        while len(self._settled) > self.max_settled_tasks:
            req_id = self._settled[0]
            t = self.tasks.get(req_id)
            if t is None:
                self._settled.popleft()
                continue
            if t.state == State.FAILED:
                if self.poison_dirty:
                    break
                self._settled.popleft()
                self._settled_failed.append(req_id)
                continue
            self._settled.popleft()
            self.tasks.pop(req_id, None)
        while len(self._settled_failed) > self.max_settled_tasks:
            self.tasks.pop(self._settled_failed.popleft(), None)

    # ------------------------------------------- migration / group lifecycle
    def hold_job(self, job_id: str):
        """Admission hold (the drain half of elastic re-placement): the
        job's QUEUED ops stop being admissible until :meth:`release_job`.
        Already-RUNNING ops complete normally."""
        with self.cv:
            if job_id in self.held_jobs:
                return
            self.held_jobs.add(job_id)
            if self.use_admission_index:
                for t in self.tasks.values():
                    if (t.state == State.QUEUED
                            and t.request.job_id == job_id):
                        self._index_remove(t)
            self.cv.notify_all()

    def release_job(self, job_id: str):
        with self.cv:
            if job_id not in self.held_jobs:
                return
            self.held_jobs.discard(job_id)
            if self.use_admission_index:
                for t in self.tasks.values():
                    if (t.state == State.QUEUED
                            and t.request.job_id == job_id
                            and self._ready(t)):
                        self._index_insert(t)
            self.cv.notify_all()

    def job_running(self, job_id: str) -> bool:
        """True while any of the job's ops is RUNNING. O(1): this is the
        migration quiesce predicate, re-checked per cv notification."""
        with self.cv:
            return self._running_count.get(job_id, 0) > 0

    def rehome_job(self, job_id: str, new_group: int) -> int:
        """Move the job's QUEUED tasks to ``new_group`` (after its state
        migrated there), keeping index membership and per-group counters
        consistent. Returns the number of tasks moved."""
        with self.cv:
            self.locks.setdefault(new_group, GroupLock())
            self.resident_job.setdefault(new_group, None)
            moved = 0
            for t in self.tasks.values():
                if (t.state != State.QUEUED
                        or t.request.job_id != job_id
                        or t.group_id == new_group):
                    continue
                if self.use_admission_index:
                    self._index_remove(t)
                self.queued_count[t.group_id] -= 1
                t.group_id = new_group
                self.queued_count[new_group] = \
                    self.queued_count.get(new_group, 0) + 1
                if self.use_admission_index and self._ready(t):
                    self._index_insert(t)
                moved += 1
            self.cv.notify_all()
            return moved

    def drop_group(self, group_id: int):
        """Forget a retired group's scheduling state. Refuses while any open
        task still targets the group."""
        with self.cv:
            open_tasks = [t.request.req_id for t in self.tasks.values()
                          if t.group_id == group_id
                          and t.state in (State.QUEUED, State.RUNNING)]
            if open_tasks:
                raise RuntimeError(
                    f"group {group_id} still has open tasks {open_tasks}")
            self.locks.pop(group_id, None)
            self.resident_job.pop(group_id, None)
            self._indexes.pop(group_id, None)
            self.queued_count.pop(group_id, None)
            self.group_busy.pop(group_id, None)
            self.group_busy_log.pop(group_id, None)
            self.group_t_load.pop(group_id, None)
            self.group_t_offload.pop(group_id, None)

    def drop_job_telemetry(self, job_id: str):
        with self.cv:
            self.phase_log.pop(job_id, None)

    def phase_records_since(self, job_id: str, seq: int) -> List[PhaseRecord]:
        """Completion records newer than ``seq`` (the profiler's cursor
        read; snapshot under the lock)."""
        with self.cv:
            log = self.phase_log.get(job_id)
            if not log:
                return []
            return [r for r in log if r.seq > seq]

    def group_busy_since(self, group_id: int, seq: int) -> List[tuple]:
        """REALIZED busy windows ``(seq, job_id, t_started, t_finished)`` on
        one group newer than ``seq`` — the reconciler's cursor read for
        measured-vs-planned occupancy drift."""
        with self.cv:
            log = self.group_busy_log.get(group_id)
            if not log:
                return []
            return [r for r in log if r[0] > seq]

    # ------------------------------------------------------------ queries
    def outstanding(self) -> int:
        """Tasks still QUEUED or RUNNING (idle when 0 and inflight == 0)."""
        with self.cv:
            return self._open

    def wait_time(self, task: Task) -> float:
        start = task.t_started if task.t_started else self.now()
        return max(0.0, start - task.t_admitted)
