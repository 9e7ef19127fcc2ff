"""The port's cluster simulator, traces and examples, on the CPU.

``core/simulator.py`` and ``core/traces.py`` are the reference's text with
``repro.`` -> ``repro_torch.``; their results equal the reference's for
the same seeds, exactly. The four examples of ``repro_torch/examples/``
run on the CPU in a child process with ``jax`` and ``repro`` blocked
(``train_100m`` with its sizes cut: its driver's argument list is checked,
then run at 2 layers of width 64); the port's ``cluster_sim`` prints the
same text as ``examples/cluster_sim.py``.
"""
import contextlib
import io
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest

from repro.core import simulator as jsim
from repro.core import traces as jtraces
from repro_torch.core import simulator as tsim
from repro_torch.core import traces as ttraces

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")

BLOCKED = ["import sys",
           "sys.modules['jax'] = None",
           "sys.modules['repro'] = None",
           "import torch",
           "torch.set_num_threads(2)"]


def _child(lines, timeout=120):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, "-c", "\n".join(BLOCKED + lines)],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


@pytest.mark.parametrize("name", ["simulator", "traces"])
def test_copied_module_is_the_reference_text(name):
    with open(os.path.join(SRC, "repro", "core", f"{name}.py")) as f:
        ref = f.read()
    with open(os.path.join(SRC, "repro_torch", "core", f"{name}.py")) as f:
        port = f.read()
    assert port == ref.replace("repro.", "repro_torch.")


def test_traces_equal_the_reference():
    assert ttraces.PAPER_TABLE2 == jtraces.PAPER_TABLE2
    for name, entry in jtraces.PAPER_TABLE2.items():
        assert ttraces.bubble_ratio(entry) == jtraces.bubble_ratio(entry)
        a, b = ttraces.paper_table2_trace(name), \
            jtraces.paper_table2_trace(name)
        assert (a.period, a.segments) == (b.period, b.segments)
    for seed in (0, 11):
        a = ttraces.synthetic_job_mix(24, seed=seed)
        b = jtraces.synthetic_job_mix(24, seed=seed)
        assert [vars(p) for p in a] == [vars(p) for p in b]


def test_policy_comparison_equals_the_reference():
    """The Fig. 8 comparison: every policy's jobs, makespan and delays."""
    kw = dict(steps=4, arrival_rate=1 / 90.0, seed=11, total_nodes=32,
              group_size=8)
    a = tsim.run_policy_comparison(ttraces.synthetic_job_mix(16, seed=11),
                                   **kw)
    b = jsim.run_policy_comparison(jtraces.synthetic_job_mix(16, seed=11),
                                   **kw)
    assert list(a) == list(b)
    for pol in a:
        assert a[pol].makespan == b[pol].makespan
        assert a[pol].utilization() == b[pol].utilization()
        np.testing.assert_array_equal(a[pol].norm_delays(),
                                      b[pol].norm_delays())
        assert [(j.job_id, j.arrival, j.t_done) for j in a[pol].jobs] == \
            [(j.job_id, j.arrival, j.t_done) for j in b[pol].jobs]


def test_cluster_sim_prints_the_reference_text():
    argv = ["--jobs", "16", "--steps", "4"]
    ref = io.StringIO()
    with contextlib.redirect_stdout(ref):
        runpy.run_path(os.path.join(ROOT, "examples", "cluster_sim.py"),
                       run_name="ref_cluster_sim")["main"](argv)
    out = _child(["from repro_torch.examples import cluster_sim",
                  f"cluster_sim.main({argv!r})"])
    assert out == ref.getvalue()
    assert "effective capacity gain" in out


def test_quickstart_runs_on_the_cpu_without_jax():
    out = _child(["from repro_torch.examples import quickstart",
                  "quickstart.main(['--device', 'cpu'])"])
    for part in ("one update_actor:", "generated: (4, 8)",
                 "serve-mode generate: (4, 8)", "quickstart on cpu took"):
        assert part in out, out


def test_multiplex_rlvr_run_and_reconciliation_without_jax():
    """``run(...)`` importable: two TINY jobs multiplexed on one CPU group
    (every step billed), then Part 5's scripted drift -> migrate."""
    out = _child([
        "from repro_torch.examples import multiplex_rlvr as mx",
        "cluster, billing, wall = mx.run(interleave=True, device='cpu')",
        "assert all(billing[j].steps == 3 for j in ('alpha', 'beta'))",
        "assert cluster.router.switch_log",
        "print('run ok', wall)",
        "mx.part5_drift_reconciliation('cpu')",
    ])
    assert "run ok" in out
    assert "'event': 'drift'" in out and "'event': 'migrate'" in out


def test_train_100m_drives_the_port_trainer_without_jax(tmp_path):
    """The example's argument list at its ~100M sizes, then the driver run
    with the same list cut to 2 layers of width 64 for the CPU."""
    out = _child([
        "from repro_torch.examples import train_100m",
        "from repro_torch.launch import train",
        "real, seen = train.main, []",
        "def cut(argv):",
        "    seen.append(list(argv))",
        "    argv = list(argv)",
        "    for flag, val in (('--layers', '2'), ('--d-model', '64'),",
        "                      ('--vocab', '128'), ('--max-new-tokens', '4'),",
        "                      ('--seq-len', '16')):",
        "        argv[argv.index(flag) + 1] = val",
        "    real(argv)",
        "train.main = cut",
        f"train_100m.main(['--steps', '1', '--device', 'cpu', '--ckpt-dir',"
        f" {str(tmp_path)!r}])",
        "a = seen[0]",
        "assert a[a.index('--layers') + 1] == '12', a",
        "assert a[a.index('--d-model') + 1] == '640', a",
        "assert a[a.index('--vocab') + 1] == '4096', a",
        "print('argv ok')",
    ])
    assert "argv ok" in out and "[job0] steps=1" in out
    assert os.path.isdir(tmp_path / "job0-train")
