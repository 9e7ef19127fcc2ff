"""Trace-driven discrete-event cluster simulator (paper §6.3, Fig. 8).

Replays a job mix through four scheduling policies:

- ``isolated``        — job-local reservation: a job holds `nodes` dedicated
                        nodes for its entire lifetime; arrivals queue FIFO.
- ``pack``            — shared groups, densest-first placement, FIFO wake
                        (head-of-line blocking preserved).
- ``spread``          — placement minimises predicted phase interference
                        against resident jobs (PlacementPolicy ranking).
- ``spread_backfill`` — spread + backfill: on wake, scan the whole wait
                        queue and start anything that fits.

Per §6.3's setup: function invocations within a job are strictly serial
(modulo optional one-step async rollout), and rollout runs on per-job
capacity while the shared pool serves the training-side functions.

Outputs: per-job normalised queueing delay (wait / ideal duration), makespan,
per-pool busy time (for GPU-hour billing), switch counts.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.scheduler.placement import (
    JobTrace, NodeGroup, PlacementConfig, PlacementPolicy, group_duty,
    least_interfering_group)
from repro_torch.core.scheduler.intervals import IntervalSet
from repro_torch.core.traces import PhaseProfile

PHASES = ("rollout", "compute_log_prob", "update_actor", "sync_weight")
SHARED = {"compute_log_prob", "update_actor", "sync_weight"}


@dataclasses.dataclass
class SimJob:
    job_id: str
    profile: PhaseProfile
    steps: int
    arrival: float
    # runtime state
    group: Optional[int] = None
    step_idx: int = 0
    phase_idx: int = 0
    t_admitted: float = -1.0
    t_done: float = -1.0
    wait_time: float = 0.0
    busy_shared: float = 0.0
    busy_rollout: float = 0.0
    switch_overhead: float = 0.0
    cycles: List[Dict[str, float]] = dataclasses.field(default_factory=list)

    def ideal_duration(self) -> float:
        return sum(sum(c.values()) for c in self.cycles)


@dataclasses.dataclass
class SimResult:
    policy: str
    jobs: List[SimJob]
    makespan: float
    shared_busy: float
    shared_capacity_time: float

    def norm_delays(self) -> np.ndarray:
        out = []
        for j in self.jobs:
            ideal = max(j.ideal_duration(), 1e-9)
            out.append(j.wait_time / ideal)
        return np.array(out)

    def utilization(self) -> float:
        return self.shared_busy / max(self.shared_capacity_time, 1e-9)


class _Group:
    def __init__(self, gid: int, capacity: int):
        self.gid = gid
        self.capacity = capacity
        self.free = capacity
        self.queue: List[Tuple[float, int, "SimJob", str, float, int]] = []
        self.resident_job: Optional[str] = None
        self.switches = 0


class ClusterSim:
    def __init__(self, total_nodes: int = 32, group_size: int = 8,
                 policy: str = "spread_backfill", seed: int = 0,
                 switch_cost: float = 4.0, horizon: float = 28_800.0,
                 duty_cap: float = 0.9):
        assert total_nodes % group_size == 0
        self.policy = policy
        self.switch_cost = switch_cost
        self.duty_cap = duty_cap
        self.rng = np.random.default_rng(seed)
        self.groups = [_Group(i, group_size)
                       for i in range(total_nodes // group_size)]
        self.placer = PlacementPolicy(
            [NodeGroup(g.gid, group_size, IntervalSet([(0.0, horizon)]))
             for g in self.groups],
            PlacementConfig(horizon=horizon))
        self._events: List[Tuple[float, int, object, tuple]] = []
        self._eseq = itertools.count()
        self.now = 0.0
        self._iso_free = total_nodes
        self._iso_queue: List[SimJob] = []
        self._busy_shared = 0.0

    # ---------------------------------------------------------- event core
    def _push(self, t: float, fn, *args):
        heapq.heappush(self._events, (t, next(self._eseq), fn, args))

    def run(self, jobs: Sequence[SimJob]) -> SimResult:
        for j in jobs:
            # pre-sample every cycle for determinism across policies
            j.cycles = [j.profile.sample_cycle(self.rng)
                        for _ in range(j.steps)]
            self._push(j.arrival, self._on_arrival, j)
        while self._events:
            t, _, fn, args = heapq.heappop(self._events)
            self.now = max(self.now, t)
            fn(*args)
        makespan = max((j.t_done for j in jobs), default=0.0) - \
            min((j.arrival for j in jobs), default=0.0)
        cap_time = sum(g.capacity for g in self.groups) * max(makespan, 1e-9)
        return SimResult(self.policy, list(jobs), makespan,
                         self._busy_shared, cap_time)

    # ------------------------------------------------------------ arrival
    def _on_arrival(self, job: SimJob):
        if self.policy == "isolated":
            self._iso_queue.append(job)
            self._try_admit_isolated()
            return
        group = self._choose_group(job)
        job.group = group.gid
        job.t_admitted = self.now
        self._start_phase(job)

    def _try_admit_isolated(self):
        while self._iso_queue:
            job = self._iso_queue[0]
            if job.profile.nodes > self._iso_free:
                break
            self._iso_queue.pop(0)
            self._iso_free -= job.profile.nodes
            job.group = 0
            job.t_admitted = self.now
            job.wait_time += self.now - job.arrival
            self._start_phase(job, isolated=True)

    def _choose_group(self, job: SimJob) -> _Group:
        trace = job.profile.mean_trace()
        if self.policy == "pack":
            # densest-first: the most-loaded group that still fits
            def load(g: _Group):
                return group_duty(self.placer.groups[g.gid])
            cands = [g for g in self.groups if g.capacity >= job.profile.nodes]
            cands.sort(key=lambda g: (-load(g), g.gid))
            for g in cands:
                duty = load(g) + trace.duty() * trace.nodes
                if duty <= g.capacity:
                    break
            else:
                g = min(self.groups, key=load)
        else:
            # spread / spread_backfill: min predicted interference — the
            # SAME ranking (placement.least_interfering_group) the live
            # reconciler uses, so simulation and the serve plane can never
            # disagree on this scoring
            ng = least_interfering_group(trace, self.placer.groups,
                                         duty_cap=self.duty_cap)
            g = (self.groups[ng.group_id] if ng is not None
                 else min(self.groups, key=lambda gg: group_duty(
                     self.placer.groups[gg.gid])))
        from repro_torch.core.scheduler.placement import Placed
        self.placer.groups[g.gid].resident.append(
            Placed(job.job_id, trace, g.gid, 0.0))
        return g

    # ------------------------------------------------------------- phases
    def _phase_info(self, job: SimJob) -> Tuple[str, float]:
        cycle = job.cycles[job.step_idx]
        name = PHASES[job.phase_idx]
        return name, cycle[name]

    def _start_phase(self, job: SimJob, isolated: bool = False):
        if job.step_idx >= job.steps:
            self._finish_job(job, isolated)
            return
        name, dur = self._phase_info(job)
        if name == "rollout" or isolated:
            # rollout pool is per-job (or the whole reservation if isolated)
            self._push(self.now + dur, self._end_phase, job, name, dur,
                       isolated)
            return
        self._request_shared(job, name, dur)

    def _request_shared(self, job: SimJob, name: str, dur: float):
        g = self.groups[job.group]
        need = job.profile.nodes
        if g.free >= need:
            self._run_shared(g, job, name, dur)
        else:
            g.queue.append((self.now, next(self._eseq), job, name, dur, need))

    def _run_shared(self, g: _Group, job: SimJob, name: str, dur: float):
        need = job.profile.nodes
        g.free -= need
        extra = 0.0
        if g.resident_job not in (None, job.job_id):
            extra = self.switch_cost
            g.switches += 1
            job.switch_overhead += extra
        g.resident_job = job.job_id
        job.busy_shared += dur + extra
        self._busy_shared += (dur + extra) * need
        self._push(self.now + dur + extra, self._end_shared, g, job, name, dur)

    def _end_shared(self, g: _Group, job: SimJob, name: str, dur: float):
        g.free += job.profile.nodes
        self._wake(g)
        self._end_phase(job, name, dur, False)

    def _wake(self, g: _Group):
        if not g.queue:
            return
        if self.policy == "spread_backfill":
            i = 0
            while i < len(g.queue):
                t_q, _, job, name, dur, need = g.queue[i]
                if need <= g.free:
                    g.queue.pop(i)
                    job.wait_time += self.now - t_q
                    self._run_shared(g, job, name, dur)
                else:
                    i += 1
        else:  # FIFO with head-of-line blocking
            while g.queue:
                t_q, _, job, name, dur, need = g.queue[0]
                if need > g.free:
                    break
                g.queue.pop(0)
                job.wait_time += self.now - t_q
                self._run_shared(g, job, name, dur)

    def _end_phase(self, job: SimJob, name: str, dur: float, isolated: bool):
        if name == "rollout":
            job.busy_rollout += dur
        elif isolated:
            job.busy_shared += dur
            self._busy_shared += dur * job.profile.nodes
        job.phase_idx += 1
        if job.phase_idx >= len(PHASES):
            job.phase_idx = 0
            job.step_idx += 1
        self._start_phase(job, isolated)

    def _finish_job(self, job: SimJob, isolated: bool):
        job.t_done = self.now
        if isolated:
            self._iso_free += job.profile.nodes
            self._try_admit_isolated()
        else:
            self.placer.groups[job.group].resident = [
                p for p in self.placer.groups[job.group].resident
                if p.job_id != job.job_id]


def run_policy_comparison(profiles: Sequence[PhaseProfile], steps: int = 20,
                          arrival_rate: float = 1 / 600.0, seed: int = 0,
                          total_nodes: int = 32, group_size: int = 8,
                          policies: Sequence[str] = ("isolated", "pack",
                                                     "spread",
                                                     "spread_backfill"),
                          ) -> Dict[str, SimResult]:
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1 / arrival_rate,
                                         size=len(profiles)))
    out = {}
    for pol in policies:
        jobs = [SimJob(f"job{i}", p, steps, float(arrivals[i]))
                for i, p in enumerate(profiles)]
        sim = ClusterSim(total_nodes=total_nodes, group_size=group_size,
                         policy=pol, seed=seed)
        out[pol] = sim.run(jobs)
    return out
