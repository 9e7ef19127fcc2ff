"""HRRS — Highest Response Ratio with Setup (paper §4.4, Algorithm 1).

Extends HRRN with the context-switch setup cost in the denominator:

    P_i(t) = rho_i * (W_i(t) + S_i(t)) / S_i(t)
           = rho_i * (1 + W_i / (E_i + 1_switch * C_setup))

which batches same-deployment requests to amortise offload/load cycles while
ageing prevents starvation. ``rho_i`` is the request's *tenant priority*
(multi-tenant service layer): a multiplicative weight on the whole score
line, 1.0 for the default tenant. The multiplicative form is deliberate —
for t >= a_i each score stays a LINE in t (slope rho/s, intercept rho at
arrival), so any two scores still cross at most once and the kinetic
tournament in ``admission_index.py`` remains a valid incremental argmax.
A priority-2 tenant's requests age twice as fast; starvation-freedom is
preserved because every line has positive slope. ``schedule`` is the
faithful Algorithm 1: score all requests (running + queued + new), sort by
score, then replay them onto a cursor timeline, prepending offload+load
whenever the job changes.

Scoring is side-effect free: ``queued_score``/``score_request`` are pure
functions of (request, now, resident job, setup cost), and ``schedule`` no
longer writes ``Request.score`` — so the incremental admission index
(``admission_index.py``) and this full-re-score oracle can score the SAME
request pool without interfering with each other. ``Request.score`` is kept
as an informational field for callers that want to stash a score, but nothing
in this module reads or writes it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Request:
    req_id: int
    job_id: str
    op: str                      # generate / forward / forward_backward / ...
    exec_time: float             # E_i estimate (profiled)
    arrival_time: float
    remaining_time: float = 0.0  # for the running request
    running: bool = False
    payload: object = None       # opaque: closure / simulated work descriptor
    priority: float = 1.0        # tenant priority rho (multiplicative score
                                 # weight; 1.0 = default tenant)
    score: float = 0.0           # informational scratch only; scoring is pure
                                 # (schedule never reads or writes this)


@dataclasses.dataclass
class Assignment:
    request: Request
    t_start: float
    t_end: float
    switched: bool


def hrrs_score(wait: float, exec_time: float, switch: bool,
               setup_cost: float, priority: float = 1.0) -> float:
    s = exec_time + (setup_cost if switch else 0.0)
    s = max(s, 1e-9)
    return priority * ((wait + s) / s)


def queued_score(exec_time: float, arrival_time: float, now: float,
                 switch: bool, setup: float, priority: float = 1.0) -> float:
    """Pure P_i(t) for a queued request: the one scoring formula shared by
    Algorithm 1's full re-score and the incremental admission index (both
    must produce bit-identical floats for the equivalence guarantee).
    ``priority`` multiplies the whole score; the default 1.0 is exact
    (``1.0 * x == x`` bit-for-bit) so untenanted callers are unchanged."""
    return hrrs_score(max(0.0, now - arrival_time), exec_time, switch, setup,
                      priority)


def score_request(r: Request, now: float, current_job: Optional[str],
                  setup: float) -> float:
    """Pure Algorithm-1 score for ``r`` (does NOT mutate ``r``)."""
    if r.running:
        return queued_score(r.remaining_time, r.arrival_time, now,
                            switch=False, setup=0.0, priority=r.priority)
    return queued_score(r.exec_time, r.arrival_time, now,
                        switch=r.job_id != current_job, setup=setup,
                        priority=r.priority)


def sort_key(r: Request, now: float, current_job: Optional[str],
             setup: float) -> Tuple[float, float, int]:
    """Algorithm 1's total admission order (highest score first; ties by
    arrival, then req_id). Exported so the admission index can break
    cross-bucket ties with the exact same key."""
    return (-score_request(r, now, current_job, setup),
            r.arrival_time, r.req_id)


def schedule(new_request: Optional[Request],
             running: Optional[Request],
             queued: Sequence[Request],
             now: float,
             current_job: Optional[str],
             t_load: float,
             t_offload: float) -> List[Assignment]:
    """Algorithm 1. Returns the re-planned timeline (V')."""
    omega: List[Request] = []
    if new_request is not None:
        omega.append(new_request)
    if running is not None:
        omega.append(running)
    omega.extend(queued)

    setup = t_load + t_offload
    omega.sort(key=lambda r: sort_key(r, now, current_job, setup))

    plan: List[Assignment] = []
    cursor = now
    resident = current_job
    first = True
    for r in omega:
        switched = False
        if r.running:
            dur = r.remaining_time
        else:
            if first and running is not None and r is not running:
                # preempting the running request costs its offload too
                switched = True
            elif r.job_id != resident:
                switched = True
            dur = r.exec_time
        if switched:
            cursor += setup
        t_start = cursor
        t_end = t_start + dur
        plan.append(Assignment(r, t_start, t_end, switched))
        cursor = t_end
        resident = r.job_id
        first = False
    return plan


def fcfs_schedule(new_request: Optional[Request],
                  running: Optional[Request],
                  queued: Sequence[Request],
                  now: float,
                  current_job: Optional[str],
                  t_load: float,
                  t_offload: float) -> List[Assignment]:
    """First-come-first-served baseline (paper §4.4's strawman)."""
    omega: List[Request] = []
    if running is not None:
        omega.append(running)
    omega.extend(queued)
    if new_request is not None:
        omega.append(new_request)
    omega.sort(key=lambda r: (not r.running, r.arrival_time, r.req_id))
    plan: List[Assignment] = []
    cursor = now
    resident = current_job
    setup = t_load + t_offload
    for r in omega:
        switched = (not r.running) and r.job_id != resident
        if switched:
            cursor += setup
        dur = r.remaining_time if r.running else r.exec_time
        plan.append(Assignment(r, cursor, cursor + dur, switched))
        cursor += dur
        resident = r.job_id
    return plan


def total_switches(plan: Sequence[Assignment]) -> int:
    return sum(1 for a in plan if a.switched)


def makespan(plan: Sequence[Assignment]) -> float:
    return plan[-1].t_end if plan else 0.0
