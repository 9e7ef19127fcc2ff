"""The port's ``multiplex_rlvr`` Parts 3, 4 and 6 on the CPU, at the
reference's head width of 12.

Each part runs in a fresh child process with ``jax`` and ``repro``
blocked, as the example runs from the command line: in a fresh process a
job's first ``update_actor`` carries one-time costs, which is what once
kept Part 6's two tenants on separate groups. The child has its own time
limit (``TIME_LIMIT_S``), and every wait inside the example fails after
``WAIT_S`` seconds, well under it.
"""
import json
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TIME_LIMIT_S = 120
WAIT_S = 60.0

PREAMBLE = [
    "import functools, json, sys",
    "sys.modules['jax'] = None",
    "sys.modules['repro'] = None",
    "import torch",
    "torch.set_num_threads(2)",
    "from repro_torch.examples import multiplex_rlvr as mx",
    f"mx.wait_until = functools.partial(mx.wait_until, timeout={WAIT_S})",
]


def _run_part(lines):
    """Run ``lines`` after the preamble in a child; returns the JSON object
    its last output line holds."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-c", "\n".join(PREAMBLE + lines)], env=env,
        capture_output=True, text=True, timeout=TIME_LIMIT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_part3_serve_mode_attaches_and_detaches_jobs():
    """A GRPO job live on group 0, a PPO job attached on group 1, a third
    job detached after its first step: every finished job is billed."""
    got = _run_part([
        "c = mx.part3_serve_mode('cpu')",
        "print(json.dumps({j: c.billing[j].steps",
        "                  for j in ('alpha', 'beta', 'gamma')}))",
    ])
    assert got["alpha"] == 3 and got["beta"] == 3, got
    assert got["gamma"] >= 1, got


def test_part4_places_jobs_through_the_control_plane():
    """Jobs added with ``group_id=None``: cold placement, the warm re-fit
    of both, and a late arrival placed too."""
    got = _run_part([
        "c = mx.part4_auto_placement('cpu')",
        "d = c.director",
        "print(json.dumps({",
        "    'events': [e['event'] for e in d.events],",
        "    'phases': {j: d.job_state(j).phase",
        "               for j in ('alpha', 'beta', 'delta')},",
        "    'steps': {j: c.billing[j].steps",
        "              for j in ('alpha', 'beta', 'delta')}}))",
    ])
    assert got["steps"] == {"alpha": 3, "beta": 3, "delta": 2}, got
    assert got["phases"]["alpha"] == got["phases"]["beta"] == "warm", got
    assert got["events"].count("cold_place") >= 2, got
    assert "warm_place" in got["events"], got


def test_part6_preempts_or_holds_the_best_effort_job():
    """The whole multi-tenant sequence: lab-2's typed denial at quota and
    its queueing, both tenants' jobs packed on one group, prod's SLO
    tightened, trigger 4's ``slo_preempt`` or ``slo_hold`` of lab-1 with
    prod-1 as its guard, and lab-2 admitted once lab-1 leaves."""
    got = _run_part([
        "c = mx.part6_multi_tenant_service('cpu')",
        "print(json.dumps({",
        "    'events': c.director.events,",
        "    'controllers': sorted(c.controllers),",
        "    'steps': {j: c.billing[j].steps for j in c.billing}}))",
    ])
    events = got["events"]
    trigger = [e for e in events if e["event"] in ("slo_preempt",
                                                   "slo_hold")]
    assert trigger, [e["event"] for e in events]
    assert trigger[0]["job"] == "lab-1" and \
        trigger[0]["guard"] == "prod-1", trigger
    breach = [e for e in events if e["event"] == "slo_breach"]
    assert breach and breach[0]["job"] == "prod-1", events
    # both jobs shared a group before the trigger: one of them was
    # re-fitted onto the other's
    first = events.index(trigger[0])
    warm = {e["job"]: e["group"] for e in events[:first]
            if e["event"] == "warm_place"}
    assert warm.get("prod-1") == warm.get("lab-1") is not None, events
    assert "lab-2" in got["controllers"], got
    assert got["steps"]["prod-1"] == 10 and got["steps"]["lab-2"] == 2, got
