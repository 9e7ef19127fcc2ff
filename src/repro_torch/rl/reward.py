"""Verifiable rewards for RLVR: exact-answer math checking.

The paper trains on a proprietary AIME-style math dataset with verifiable
answers; we substitute a synthetic arithmetic task (repro.rl.data) whose
answers are checked exactly — the same "verifier" role, fully reproducible.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence

import numpy as np


def extract_answer(text: str) -> Optional[int]:
    """Pull the final integer answer out of a generated completion."""
    matches = re.findall(r"-?\d+", text)
    if not matches:
        return None
    return int(matches[-1])


def verify(completion: str, target: int) -> float:
    """Binary verifiable reward: 1.0 iff the final integer equals target."""
    got = extract_answer(completion)
    return 1.0 if got is not None and got == target else 0.0


def batch_rewards(completions: Sequence[str], targets: Sequence[int]) -> np.ndarray:
    return np.array([verify(c, t) for c, t in zip(completions, targets)],
                    dtype=np.float32)


class ToolStallSimulator:
    """Models agentic tool-call stalls (paper §2: long-tailed rollouts).

    Draws per-sample tool latencies from a lognormal so the rollout phase
    exhibits the paper's characteristic long tail. Used by the cluster
    simulator and benchmarks; deterministic under a seed.
    """

    def __init__(self, p_tool: float = 0.3, mu: float = 0.0, sigma: float = 1.0,
                 scale: float = 2.0, seed: int = 0):
        self.p_tool = p_tool
        self.mu, self.sigma, self.scale = mu, sigma, scale
        self.rng = np.random.default_rng(seed)

    def sample_stalls(self, n: int) -> np.ndarray:
        has_tool = self.rng.random(n) < self.p_tool
        stalls = self.rng.lognormal(self.mu, self.sigma, n) * self.scale
        return np.where(has_tool, stalls, 0.0).astype(np.float32)
