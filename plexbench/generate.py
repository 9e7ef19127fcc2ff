"""The one traffic generator: every mix is a data file under
``plexbench/traffic/`` that this module reads.

All inputs come from ``--seed`` through numpy's ``SeedSequence`` (any
non-negative whole number, however large), on the host, during set-up:

- ``train`` mixes: per job, ``batches_per_job`` packed GRPO batches of
  ``prompts * group`` rows of ``prompt_len + response_len`` tokens, with the
  keys ``pack_rollout_batch`` gives (tokens, behavior_logprobs, advantages,
  loss_mask): every prompt repeated ``group`` times, a response drawn per
  row, the loss mask on the responses, behaviour log-probs about
  ``-ln(vocab)``, a 0/1 reward a row and advantages normalised per group;
- ``rollout`` mixes: per job, ``batches_per_job`` prompt batches of
  ``prompts * group`` rows of ``prompt_len`` tokens (each prompt repeated
  ``group`` times).

Token ids are uniform over [3, vocab): 0-2 are pad, bos and eos.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

FIRST_ID = 3


def rng_for(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *keys]))


def group_advantages(rewards: np.ndarray, group: int,
                     eps: float = 1e-6) -> np.ndarray:
    """(r - mean) / (std + eps) within each group of ``group`` consecutive
    rows, the population std."""
    g = rewards.reshape(-1, group).astype(np.float32)
    mean = g.mean(axis=1, keepdims=True)
    std = g.std(axis=1, keepdims=True)
    return ((g - mean) / (std + eps)).reshape(-1).astype(np.float32)


def pack(prompts: np.ndarray, responses: np.ndarray, behave: np.ndarray,
         rewards: np.ndarray, group: int) -> Dict[str, np.ndarray]:
    """One packed GRPO batch: prompt then response in each row, the
    behaviour log-probs and the loss mask on the response positions."""
    b, p = prompts.shape
    s = p + responses.shape[1]
    tokens = np.zeros((b, s), dtype=np.int32)
    logp = np.zeros((b, s), dtype=np.float32)
    mask = np.zeros((b, s), dtype=np.float32)
    tokens[:, :p] = prompts
    tokens[:, p:] = responses
    logp[:, p:] = behave
    mask[:, p:] = 1.0
    return {"tokens": tokens, "behavior_logprobs": logp,
            "advantages": group_advantages(rewards, group),
            "loss_mask": mask}


def prompt_rows(rng: np.random.Generator, mix: dict,
                vocab: int) -> np.ndarray:
    """``prompts`` prompts of ``prompt_len`` ids, each repeated ``group``
    times."""
    base = rng.integers(FIRST_ID, vocab, size=(mix["prompts"],
                                               mix["prompt_len"]))
    return np.repeat(base, mix["group"], axis=0).astype(np.int32)


def train_batch(mix: dict, vocab: int, seed: int, job: int,
                index: int) -> Dict[str, np.ndarray]:
    rng = rng_for(seed, job, index)
    prompts = prompt_rows(rng, mix, vocab)
    rows = prompts.shape[0]
    responses = rng.integers(FIRST_ID, vocab, size=(rows, mix["response_len"]))
    behave = -math.log(vocab) + mix["behavior_logprob_sd"] * \
        rng.standard_normal((rows, mix["response_len"]))
    rewards = (rng.random(rows) < mix["reward_p"]).astype(np.float32)
    return pack(prompts, responses.astype(np.int32),
                behave.astype(np.float32), rewards, mix["group"])


def rollout_batch(mix: dict, vocab: int, seed: int, job: int,
                  index: int) -> np.ndarray:
    return prompt_rows(rng_for(seed, job, index), mix, vocab)


def job_inputs(mix: dict, vocab: int, seed: int) -> List[list]:
    """Per job, its pool of ``batches_per_job`` inputs."""
    make = train_batch if mix["kind"] == "train" else rollout_batch
    return [[make(mix, vocab, seed, j, i)
             for i in range(mix["batches_per_job"])]
            for j in range(mix["jobs"])]


def rows(mix: dict) -> int:
    return mix["prompts"] * mix["group"]


def seq_len(mix: dict) -> int:
    return mix["prompt_len"] + mix.get("response_len", 0)
