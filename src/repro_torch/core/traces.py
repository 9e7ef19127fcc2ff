"""Demand-trace profiling and synthetic trace generation.

A job's *trace* is its periodic execution signature: the per-cycle phase
durations (rollout / compute_log_prob / update_actor / sync_weight) plus the
node demand of each phase. Cold-start jobs run isolated while the profiler
records one clean cycle (paper §4.3.2); warm-start jobs are placed by trace
fitting.

``paper_table2_trace`` reproduces the measured cycle anatomy of Table 2
(7B / 30B / 235B), including the 70-81 % bubble ratios; synthetic traces add
long-tail jitter from the tool-stall model (§2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.scheduler.placement import JobTrace

# Table 2 (seconds): cycle time and active-phase anatomy.
PAPER_TABLE2 = {
    "7B": {"cycle": 289.03, "compute_log_prob": 9.66, "update_actor": 38.08,
           "sync_weight": 9.76},
    "30B": {"cycle": 284.80, "compute_log_prob": 19.62, "update_actor": 56.35,
            "sync_weight": 7.57},
    "235B": {"cycle": 589.71, "compute_log_prob": 20.11, "update_actor": 82.39,
             "sync_weight": 8.89},
}


def bubble_ratio(entry: Dict[str, float]) -> float:
    """Fraction of the cycle in which the training pool is idle (Tab. 2)."""
    active = (entry["compute_log_prob"] + entry["update_actor"]
              + entry["sync_weight"])
    return 1.0 - active / entry["cycle"]


def paper_table2_trace(size: str, nodes: int = 1) -> JobTrace:
    """JobTrace of the TRAINING pool for a Table-2 job: active segments are
    logprob + update + sync back-to-back after the rollout gap."""
    e = PAPER_TABLE2[size]
    rollout_gap = e["cycle"] - (e["compute_log_prob"] + e["update_actor"]
                                + e["sync_weight"])
    t = rollout_gap
    segs: List[Tuple[float, float]] = []
    for phase in ("compute_log_prob", "update_actor", "sync_weight"):
        segs.append((t, e[phase]))
        t += e[phase]
    return JobTrace(period=e["cycle"], segments=tuple(segs), nodes=nodes)


@dataclasses.dataclass
class PhaseProfile:
    """Mean/σ per phase; sampling yields one cycle's realised durations."""
    rollout_mean: float
    rollout_tail_sigma: float           # lognormal sigma of the tool tail
    logprob: float
    update: float
    sync: float
    nodes: int = 1

    def sample_cycle(self, rng: np.random.Generator) -> Dict[str, float]:
        tail = rng.lognormal(0.0, self.rollout_tail_sigma)
        return {
            "rollout": self.rollout_mean * max(0.25, tail),
            "compute_log_prob": self.logprob * rng.uniform(0.9, 1.1),
            "update_actor": self.update * rng.uniform(0.95, 1.05),
            "sync_weight": self.sync * rng.uniform(0.9, 1.1),
        }

    def mean_trace(self) -> JobTrace:
        t = self.rollout_mean
        segs = [(t, self.logprob), (t + self.logprob, self.update),
                (t + self.logprob + self.update, self.sync)]
        period = t + self.logprob + self.update + self.sync
        return JobTrace(period=period, segments=tuple(segs), nodes=self.nodes)


def synthetic_job_mix(n_jobs: int, seed: int = 0,
                      sizes: Sequence[str] = ("7B", "30B", "235B"),
                      node_counts: Sequence[int] = (1, 2, 8),
                      ) -> List[PhaseProfile]:
    """A cluster-months-style mix: jobs shaped like Table 2 with scaled
    rollout tails (agentic GRPO per §6.3's replay setup)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_jobs):
        i = int(rng.integers(0, len(sizes)))
        e = PAPER_TABLE2[sizes[i]]
        active = e["compute_log_prob"] + e["update_actor"] + e["sync_weight"]
        rollout = (e["cycle"] - active) * rng.uniform(0.7, 1.4)
        out.append(PhaseProfile(
            rollout_mean=rollout,
            rollout_tail_sigma=rng.uniform(0.2, 0.6),
            logprob=e["compute_log_prob"] * rng.uniform(0.8, 1.2),
            update=e["update_actor"] * rng.uniform(0.8, 1.2),
            sync=e["sync_weight"] * rng.uniform(0.8, 1.2),
            nodes=int(node_counts[i]),
        ))
    return out


class Profiler:
    """Cold-start profiler: records phase durations over one isolated cycle
    and emits the JobTrace used for warm placement."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = {}

    def record(self, phase: str, duration: float):
        self.samples.setdefault(phase, []).append(duration)

    def trace(self, nodes: int = 1) -> Optional[JobTrace]:
        needed = ("rollout", "update_actor")
        if not all(p in self.samples for p in needed):
            return None
        mean = {p: float(np.mean(v)) for p, v in self.samples.items()}
        t = mean.get("rollout", 0.0)
        segs = []
        for p in ("compute_log_prob", "update_actor", "sync_weight"):
            if p in mean:
                segs.append((t, mean[p]))
                t += mean[p]
        return JobTrace(period=t, segments=tuple(segs), nodes=nodes)
