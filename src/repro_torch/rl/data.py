"""Synthetic verifiable-math data pipeline.

Generates arithmetic reasoning prompts ("17 + 4 * 3 = ?") with exact integer
answers, a character-level tokenizer confined to the low end of any model's
vocab, and packed/padded batches. Deterministic under seeds; infinite
iterator semantics for training.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.rl.grpo import group_relative_advantages

# char-level tokenizer: reserve 0=pad, 1=bos, 2=eos
_CHARS = "0123456789+-*() =?"
PAD, BOS, EOS = 0, 1, 2
_OFFSET = 3
VOCAB_MIN = _OFFSET + len(_CHARS)


def encode(text: str) -> List[int]:
    return [BOS] + [_OFFSET + _CHARS.index(c) for c in text if c in _CHARS]


def decode(ids) -> str:
    out = []
    for i in ids:
        i = int(i)
        if i == EOS:
            break
        if i >= _OFFSET and i - _OFFSET < len(_CHARS):
            out.append(_CHARS[i - _OFFSET])
    return "".join(out)


@dataclasses.dataclass(frozen=True)
class Problem:
    prompt: str
    answer: int
    difficulty: int       # 1..5, mirroring the paper's 5 difficulty buckets


def sample_problem(rng: np.random.Generator, difficulty: int) -> Problem:
    """Difficulty scales the number of operands (paper: 5 AIME-like tiers)."""
    n_ops = difficulty + 1
    terms = rng.integers(1, 10 ** min(difficulty, 3), size=n_ops)
    ops = rng.choice(["+", "-", "*"], size=n_ops - 1)
    expr = str(terms[0])
    for op, t in zip(ops, terms[1:]):
        expr += f" {op} {t}"
    return Problem(prompt=f"{expr} = ?", answer=int(eval(expr)),
                   difficulty=difficulty)


class MathDataset:
    """~45k-sample synthetic dataset across 5 difficulties (paper §6.1)."""

    def __init__(self, size: int = 45_000, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.size = size

    def sample(self, n: int) -> List[Problem]:
        return [sample_problem(self.rng, int(self.rng.integers(1, 6)))
                for _ in range(n)]

    def batches(self, batch_size: int, seq_len: int,
                group_size: int = 1) -> Iterator[Tuple[np.ndarray, List[Problem]]]:
        """Yields (tokens (B, S), problems). Each prompt repeated group_size
        times (GRPO grouping)."""
        while True:
            probs = self.sample(batch_size // group_size)
            probs = [p for p in probs for _ in range(group_size)]
            tokens = np.full((batch_size, seq_len), PAD, dtype=np.int32)
            for i, p in enumerate(probs):
                ids = encode(p.prompt)[:seq_len]
                tokens[i, :len(ids)] = ids
            yield tokens, probs



def pack_rollout_batch(prompt_tokens: np.ndarray, completions: np.ndarray,
                       logprobs: np.ndarray, rewards: np.ndarray,
                       group_size: int, seq_len: int):
    """Assemble the GRPO train batch from rollout artifacts (numpy).

    prompt_tokens: (B, P); completions: (B, C); logprobs: (B, C) behavior
    logprobs of completion tokens; rewards: (B,).
    """
    b, p_len = prompt_tokens.shape
    c_len = completions.shape[1]
    tokens = np.full((b, seq_len), PAD, dtype=np.int32)
    behave = np.zeros((b, seq_len), dtype=np.float32)
    mask = np.zeros((b, seq_len), dtype=np.float32)
    n = min(seq_len, p_len + c_len)
    tokens[:, :p_len] = prompt_tokens
    tokens[:, p_len:n] = completions[:, :n - p_len]
    behave[:, p_len:n] = logprobs[:, :n - p_len]
    mask[:, p_len:n] = 1.0
    adv = group_relative_advantages(
        torch.from_numpy(np.asarray(rewards, np.float32)), group_size).numpy()
    return {
        "tokens": tokens,
        "behavior_logprobs": behave,
        "advantages": adv,
        "loss_mask": mask,
    }
