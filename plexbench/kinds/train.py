"""Training mixes: each job's client loops on a FORWARD (log-probs) and an
UPDATE_ACTOR of a packed GRPO batch.

Set-up drives every job through its first ``check_steps`` steps by the
window's own clients, all jobs at once (so on a shared group the dispatch
plane interleaves their ops and switches between them as in the window),
on batches that all differ. It keeps of job 0 what the check compares:
each step's loss, the first FORWARD's log-probs, its first gradient as
AdamW holds it after one step (mu / (1 - b1)) and each leaf's change after
the last of those steps, before step 4 overwrites them; and of every job,
its parameters at its first FORWARD (after an offload and a load, on a
shared group, for every job but the one the plane ran first), bit for bit
against the weights handed in. The state is read on the dispatch thread
as each op resolves, before the group runs another op or moves any state.

After the window every job's parameters and AdamW moments are read where
they lie, then again after one more change of job each way, bit for bit.
The reference follows job 0's first steps from the seed's weights.
"""
from __future__ import annotations

import functools
import math
import threading
from typing import Dict

from plexbench import flops, generate
from plexbench import weights as wts
from plexbench.harness import LATE_S, Window
from plexbench.session import BaseSession, bits_mismatch, norm

# the most set-up's first steps may take
FIRST_STEPS_S = 900.0


class Session(BaseSession):
    role = "train"
    rate_metric = "train_tokens_per_s"

    def setup(self):
        mix, cfg = self.mix, self.cfg
        self.inputs = generate.job_inputs(mix, cfg["vocab_size"], self.seed)
        self.rows, self.seq = generate.rows(mix), generate.seq_len(mix)
        self.deploy()
        steps = mix["check_steps"]
        self.prog = {"losses": {}, "logp0": None, "grad1": None,
                     "change": None}
        self.first_params: Dict[int, int] = {}
        self.read_errors = []
        self.state_gap = None
        self.step0, self.reading = 0, True
        first = Window(self, FIRST_STEPS_S, False,
                       ops=steps * len(mix["loop"]))
        first.run()
        bad = [s["error"] for s in first.spans if not s["ok"]]
        if bad or first.stragglers:
            raise RuntimeError(f"set-up's first steps failed: {bad[:3]} "
                               f"{first.stragglers}")
        # the losses in step order (a step whose loss is missing shortens
        # the list, which the check fails)
        got = self.prog["losses"]
        self.prog["losses"] = [got[i] for i in range(steps) if i in got]
        self.reading = False
        self.step0 = steps
        self.mark()

    # ------------------------------------------------------------ ops
    def submit(self, job: int, k: int):
        loop = self.mix["loop"]
        op = loop[k % len(loop)]
        step = self.step0 + k // len(loop)
        batch = self.inputs[job][step % self.mix["batches_per_job"]]
        dep = self.deps[job]
        if op == "forward":
            fut = dep.forward(batch)
            work = 0
            f = flops.forward_flops(self.cfg, self.rows, self.seq)
        else:
            fut = dep.update_actor(batch)
            work = self.rows * self.seq
            f = flops.update_flops(self.cfg, self.rows, self.seq)
        if self.reading:
            fut.add_done_callback(functools.partial(
                self.read_state, job, step, op))
        return fut, {"op": op, "work": work, "flops": f}

    def keep(self, job: int, k: int, span: dict, result):
        if not self.reading or job:
            return
        step = k // len(self.mix["loop"])
        if span["op"] == "update_actor":
            self.prog["losses"][step] = result["loss"]
        elif step == 0:
            self.prog["logp0"] = result.float().cpu()

    def read_state(self, job: int, step: int, op: str, fut):
        """What set-up keeps of the program's state, read on the dispatch
        thread as the op resolves: the job is resident and the group runs
        nothing else until this returns."""
        try:
            fut.result()
        except Exception:  # noqa: BLE001 - the op's own span records it
            return
        try:
            if not threading.current_thread().name.startswith("serve-"):
                raise RuntimeError("a state read off the dispatch thread")
            if op == "forward" and step == 0:
                self.first_params[job] = self.leaf_mismatch(job)
            if job or op != "update_actor":
                return
            dep = self.deps[job]
            if step == 0:
                b1 = self.cfg["optimizer"]["b1"]
                mu = self.port.by_reference_name(dep.wpg.opt_state().mu)
                self.prog["grad1"] = {k: norm(t) / (1 - b1)
                                      for k, t in mu.items()}
            if step == self.mix["check_steps"] - 1:
                self.prog["change"] = self.changes(dep)
        except Exception as e:  # noqa: BLE001 - fails the check
            self.read_errors.append(repr(e)[:300])

    def changes(self, dep) -> Dict[str, float]:
        """Each leaf's change from the seed's weights, one leaf at a time."""
        tree = self.port.by_reference_name(dep.wpg.params())
        out = {}
        for name, t in tree.items():
            p0 = wts.make_leaf(self.cfg, self.seed, 0, name, self.device)
            out[name] = norm(t.float().reshape(-1) - p0.float().reshape(-1))
        return out

    # ------------------------------------------------ after the window
    def after_window(self, win):
        record = super().after_window(win)
        try:
            self.state_gap = self.round_trip()
        except Exception as e:  # noqa: BLE001 - fails the check
            self.read_errors.append(repr(e)[:300])
            self.state_gap = math.inf
        return record

    def state_copy(self, job: int) -> Dict[str, object]:
        """A copy on the device of a job's parameters and AdamW state,
        read where they lie (on the device or in host memory)."""
        wpg = self.deps[job].wpg
        tree = {"params": wpg.params(), "opt": wpg.opt_state()._asdict()}
        return {k: t.detach().to(self.device, copy=True)
                for k, t in self.port.flat(tree).items()}

    def round_trip(self) -> float:
        """Every job's state after the window, against the same state after
        one more change of job each way: a FORWARD a job, the resident job
        last, so each job is loaded (and the resident one offloaded first)
        before it is read again. Bits that differ, over all jobs."""
        snaps = {j: self.state_copy(j) for j in range(self.jobs)}
        resident = [j for j, d in enumerate(self.deps) if d.wpg.resident()]
        last = resident[0] if resident else self.jobs - 1
        differ = 0
        for i in range(1, self.jobs + 1):
            j = (last + i) % self.jobs
            self.deps[j].forward(self.inputs[j][0]).wait(timeout=LATE_S)
            now = self.state_copy(j)
            if set(now) != set(snaps[j]):
                return math.inf
            differ += sum(bits_mismatch(now[k], snaps[j][k]) for k in now)
            del now, snaps[j]
        return float(differ)

    # ------------------------------------------------------------- check
    def reference(self, precision: str = "f32", rows=None) -> dict:
        """The reference's readings of job 0's first steps, from the seed's
        weights, after the program's state is gone."""
        self.ref.strict_f32()
        w = wts.make_weights(self.cfg, self.seed, 0, self.device)
        batches = [self.to_device(self.inputs[0][i])
                   for i in range(self.mix["check_steps"])]
        out = self.ref.train_steps(w, self.cfg, batches,
                                   self.mix["reference_rows"], precision,
                                   rows)
        del w
        return out

    def compare(self, prog: dict, ref: dict) -> Dict[str, float]:
        """The numbers the check holds to their limits."""
        r = self.ref
        if len(prog["losses"]) == len(ref["losses"]):
            loss_gap = max(abs(a - b) for a, b in zip(prog["losses"],
                                                       ref["losses"]))
        else:
            loss_gap = math.inf
        lp = prog["logp0"]
        if lp is None or lp.shape != ref["logp0"].shape:
            lp_gap = math.inf
        else:
            lp_gap = float((lp.to(ref["logp0"].device)
                            - ref["logp0"]).abs().max())
        leaves = list(ref["grad1"])
        missing = prog["grad1"] is None or prog["change"] is None
        return {
            "loss_gap": r.sanity(loss_gap),
            "logprob_gap": r.sanity(lp_gap),
            "grad_gap": math.inf if missing else r.sanity(
                r.worst_leaf_gap(prog["grad1"], ref["grad1"], leaves)),
            "change_gap": math.inf if missing else r.sanity(
                r.worst_leaf_gap(prog["change"], ref["change"],
                                 r.moving_leaves(ref["raw_grad1"]))),
        }

    def check(self, record) -> Dict[str, float]:
        self.last_ref = self.reference()
        numbers = self.compare(self.prog, self.last_ref)
        whole = len(self.first_params) == self.jobs and not self.read_errors
        numbers["roundtrip_mismatch"] = float(
            sum(self.first_params.values())) if whole else math.inf
        if self.state_gap is not None:
            numbers["state_mismatch"] = self.state_gap
        return numbers
