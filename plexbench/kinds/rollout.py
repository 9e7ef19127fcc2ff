"""Rollout mixes: each job's client loops on GENERATE of a batch of prompts.

Each job's k-th GENERATE samples at ``temperature[k % len(temperature)]``:
most at temperature 1, as RLVR rollouts sample, and a few at 0, greedy, so
that the served model's tokens can be judged by the reference's logits. A
sampled request's tokens are judged by the log-probs the port returned for
them. Set-up runs one GENERATE a job (``warmup_new_tokens`` long at
``warmup_temperature``), so every shape and both ways of picking a token
have run, and each job has been offloaded once (its pinned buffers exist).

The check: once the window has closed, the resident job's parameters bit
for bit against the weights handed in (they have been switched out and in
through the window); then, of each kind (greedy, sampled), one GENERATE
drawn from the seed among those that finished in the window, all jobs',
and ``check_rows`` of its rows drawn from the seed: the reference runs
once over each prompt with its served tokens, and judges each token the
port served while the row was alive (up to and with its first eos).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from plexbench import flops, generate
from plexbench import weights as wts
from plexbench.session import BaseSession


class Session(BaseSession):
    role = "rollout"
    rate_metric = "rollout_tokens_per_s"

    def setup(self):
        mix, cfg = self.mix, self.cfg
        self.inputs = generate.job_inputs(mix, cfg["vocab_size"], self.seed)
        self.rows = generate.rows(mix)
        self.deploy()
        for j, dep in enumerate(self.deps):
            dep.generate(self.inputs[j][0],
                         max_new_tokens=mix["warmup_new_tokens"][j],
                         temperature=mix["warmup_temperature"][j]).wait()
        self.results: Dict[int, List] = {j: [] for j in range(self.jobs)}
        self.mark()

    def submit(self, job: int, k: int):
        mix = self.mix
        idx = k % mix["batches_per_job"]
        temps = mix["temperature"]
        temp = temps[k % len(temps)]
        fut = self.deps[job].generate(
            self.inputs[job][idx], max_new_tokens=mix["new_tokens"],
            temperature=temp)
        return fut, {"op": "generate", "batch": idx, "greedy": temp <= 0,
                     "label": "greedy" if temp <= 0 else f"T={temp:g}",
                     "work": self.rows * mix["new_tokens"],
                     "flops": flops.generate_flops(
                         self.cfg, self.rows, mix["prompt_len"],
                         mix["new_tokens"])}

    def keep(self, job: int, k: int, span: dict, result):
        self.results[job].append(
            (span, {n: t.cpu() for n, t in result.items()}))

    def after_window(self, win):
        record = super().after_window(win)
        resident = [j for j, d in enumerate(self.deps) if d.wpg.resident()]
        self.roundtrip = sum(self.leaf_mismatch(j) for j in resident) \
            if resident else -1
        return record

    # ------------------------------------------------------------- check
    def sample(self) -> List[dict]:
        """Of each kind (greedy, then sampled), one GENERATE that finished
        in the window, drawn from the seed among every job's, and
        ``check_rows`` of its rows: the prompt, the served tokens, the
        port's log-probs and which tokens count."""
        rng = generate.rng_for(self.seed, 1 << 20)
        out = []
        for greedy in (True, False):
            done = [(j, r) for j in range(self.jobs) for r in self.results[j]
                    if r[0]["ok"] and r[0]["greedy"] == greedy]
            if not done:
                continue
            j, (span, res) = done[int(rng.integers(len(done)))]
            rows = rng.choice(self.rows, size=self.mix["check_rows"],
                              replace=False)
            alive = res["alive"][rows]
            # a token counts while its row was alive before it
            valid = torch.cat([torch.ones_like(alive[:, :1]), alive[:, :-1]],
                              dim=1)
            out.append({
                "job": j, "greedy": greedy,
                "prompt": torch.as_tensor(self.inputs[j][span["batch"]][rows]),
                "tokens": res["tokens"][rows].long(),
                "logprobs": res["logprobs"][rows].float(),
                "valid": valid})
        return out

    def reference_logits(self, sample: List[dict], weights,
                         precision: str = "f32") -> List[torch.Tensor]:
        """The reference's logits over each drawn row's prompt and served
        tokens, a few rows at a time."""
        out = []
        step = self.mix["reference_rows"]
        for s in sample:
            full = torch.cat([s["prompt"].long(), s["tokens"]], dim=1).to(
                self.device)
            out.append(torch.cat([
                self.ref.served_logits(weights, self.cfg, full[r:r + step],
                                       self.mix["prompt_len"], precision)
                for r in range(0, full.shape[0], step)]).cpu())
        return out

    @staticmethod
    def compare(sample: List[dict], logits: List[torch.Tensor]
                ) -> Dict[str, float]:
        """``greedy_gap``: the widest gap by which a greedy job's served
        token's reference logit lies below the reference's best;
        ``logprob_gap``: the widest difference between a sampling job's
        served log-prob and the reference's."""
        greedy, logprob = 0.0, 0.0
        seen = {"greedy": False, "logprob": False}
        for s, lg in zip(sample, logits):
            tok = s["tokens"][..., None]
            v = s["valid"]
            if s["greedy"]:
                gap = lg.max(dim=-1).values - lg.gather(-1, tok)[..., 0]
                greedy = max(greedy, float(gap[v].max()))
                seen["greedy"] = True
            else:
                ref_lp = torch.log_softmax(lg, dim=-1).gather(-1, tok)[..., 0]
                diff = (s["logprobs"] - ref_lp).abs()
                logprob = max(logprob, float(diff[v].max()))
                seen["logprob"] = True
        out = {}
        if seen["greedy"]:
            out["greedy_gap"] = greedy if np.isfinite(greedy) else float("inf")
        if seen["logprob"]:
            out["logprob_gap"] = logprob if np.isfinite(logprob) \
                else float("inf")
        return out

    def check(self, record) -> Dict[str, float]:
        self.ref.strict_f32()
        sample = self.sample()
        logits = []
        for s in sample:
            w = wts.make_weights(self.cfg, self.seed, s["job"], self.device)
            logits += self.reference_logits([s], w)
            del w
        # a kind of request with nothing finished to judge fails its number
        temps = self.mix["temperature"]
        numbers = {n: float("inf") for n, want in (
            ("greedy_gap", any(t <= 0 for t in temps)),
            ("logprob_gap", any(t > 0 for t in temps))) if want}
        numbers.update(self.compare(sample, logits))
        self.last_sample, self.last_logits = sample, logits
        numbers["roundtrip_mismatch"] = float(self.roundtrip) \
            if self.roundtrip >= 0 else float("inf")
        return numbers
