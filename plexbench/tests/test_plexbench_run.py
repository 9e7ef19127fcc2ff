"""Whole runs of the harness on the CPU at the tiny dense preset (the look
for a card skipped): the result line, the check's numbers, and ``correct``
coming out false when the timed path is broken underneath."""
import json
from pathlib import Path

import pytest
import torch

from plexbench import harness

DATA = Path(__file__).resolve().parent / "data"
BENCH = json.loads((DATA / "bench.json").read_text())


def _run(name, seed=2 ** 35 + 11, seconds=1.5, trace=False):
    from repro_torch.launch.mesh import DevicePlane
    cell = harness.Cell(name, BENCH, data=DATA)
    run = harness.Run(cell, seed, seconds, trace, device="cpu",
                      cluster_kwargs={"device_plane": DevicePlane(
                          devices=["cpu"])})
    return run.execute(), run


@pytest.mark.parametrize("name,rate", [
    ("tiny.train_mux", "train_tokens_per_s"),
    ("tiny.rollout_mux", "rollout_tokens_per_s"),
])
def test_a_sound_run_is_correct_and_reports_its_metrics(name, rate):
    result, run = _run(name)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 2
    assert set(result["metrics"]) >= {rate, "setup_s"}
    assert list(result)[-1] == "checks"
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}


def test_traced_run_reports_per_layer_metrics_only():
    result, _ = _run("tiny.train_mux", trace=True)
    names = set(result["metrics"])
    # off the card there is no device trace: the span readers still read
    assert {"queue_wait_s.train", "update_s.train", "switch_s.train",
            "mfu.train"} <= names
    assert "train_tokens_per_s" not in names
    assert not any("roofline" in n or "idle" in n for n in names)


def test_report_puts_the_numbers_last(capsys):
    result, run = _run("tiny.rollout_mux")
    harness.report(result, run.notes)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert all(s.startswith("check ") and " limit " in s for s in last)


# ---------------------------------------------------------------- faults

def test_fault_a_step_that_leaves_the_state_unchanged(monkeypatch):
    from repro_torch.rl import grpo
    from repro_torch.train import optimizer

    def unchanged(grads, state, params, cfg=None):
        return {"grad_norm": torch.zeros(()), "lr": torch.zeros(())}

    monkeypatch.setattr(optimizer, "update_", unchanged)
    monkeypatch.setattr(grpo.opt, "update_", unchanged)
    result, _ = _run("tiny.train_mux")
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] >= 0.99


def test_fault_half_the_batch_left_out(monkeypatch):
    from repro_torch.core import worker

    real = worker.WorkerProcessGroup._op_update_actor

    def half(self, batch):
        n = batch["tokens"].shape[0] // 2
        return real(self, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(worker.WorkerProcessGroup, "_op_update_actor", half)
    result, _ = _run("tiny.train_mux")
    assert not result["correct"]
    assert result["checks"]["loss_gap"]["value"] > \
        result["checks"]["loss_gap"]["limit"]


def test_fault_a_switch_that_alters_the_state(monkeypatch):
    """A load through the state layer that alters one element of each
    AdamW moment it brings back to the device."""
    from repro_torch.core import state_manager as smod

    real = smod.StateManager.prefetch

    def altered(self, keys):
        moving = [k for k in keys if k in self.entries
                  and self.entries[k].tier != smod.Tier.DEVICE]
        dt = real(self, keys)
        for k in moving:
            t = self.entries[k].ref
            if "/opt/" in k and torch.is_tensor(t) and t.numel() > 1:
                t.view(-1)[0] += 1.0
        return dt

    monkeypatch.setattr(smod.StateManager, "prefetch", altered)
    result, _ = _run("tiny.train_mux")
    assert not result["correct"]
    assert result["checks"]["state_mismatch"]["value"] > 0


def test_fault_an_answer_altered_where_it_is_produced(monkeypatch):
    from repro_torch.core import worker

    real = worker.WorkerProcessGroup._op_forward

    def altered(self, batch, output="logprobs"):
        out = real(self, batch, output)
        out[0, -1] += 0.5
        return out

    monkeypatch.setattr(worker.WorkerProcessGroup, "_op_forward", altered)
    result, _ = _run("tiny.train_mux")
    assert not result["correct"]
    assert result["checks"]["logprob_gap"]["value"] >= 0.49


@pytest.mark.parametrize("greedy", [True, False])
def test_fault_a_served_token_altered(monkeypatch, greedy):
    """A GENERATE whose every row's third token is replaced after sampling
    (its log-prob left as sampled)."""
    from repro_torch.rl import rollout as rollout_lib

    real = rollout_lib.rollout

    def altered(model, params, prompt_tokens, gen, cfg, **kw):
        toks, logps, alive = real(model, params, prompt_tokens, gen, cfg,
                                  **kw)
        if cfg.max_new_tokens > 2 and (cfg.temperature <= 0) == greedy:
            toks = toks.clone()
            toks[:, 2] = (toks[:, 2] + 1 - 3) % (
                model.cfg.vocab_size - 3) + 3
        return toks, logps, alive

    monkeypatch.setattr(rollout_lib, "rollout", altered)
    result, _ = _run("tiny.rollout_mux")
    assert not result["correct"]
    name = "greedy_gap" if greedy else "logprob_gap"
    c = result["checks"][name]
    assert c["value"] > c["limit"]


def test_the_exchange_between_chips_has_no_fault_to_plant():
    # every cell runs on one chip: nothing is exchanged between chips
    for w in json.loads((harness.REPO / "BENCHMARK.json").read_text())[
            "workloads"]:
        assert w["chips"] == 1


# --------------------------------------------------------------- control

def test_control_fails_a_number_of_each_cell_at_a_tiny_size():
    """The reference in fp8 put in the program's place reads past the
    tiny cells' limits on some number, as it does at the cells' own sizes
    on the card (``plexbench/calibrate.py``)."""
    from plexbench import calibrate
    from repro_torch.launch.mesh import DevicePlane
    for name in ("tiny.train_mux", "tiny.rollout_mux"):
        cell = harness.Cell(name, BENCH, data=DATA)
        row = calibrate.one_seed(cell, 2 ** 33 + 5, True, "cpu",
                                 {"device_plane": DevicePlane(
                                     devices=["cpu"])})
        ctrl = row["control_fp8"]
        assert any(v > cell.limits[k] for k, v in ctrl.items()), (name, row)
        assert all(v <= cell.limits[k] for k, v in row["program"].items())
