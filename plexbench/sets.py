"""Two sets of runs of one cell over the same seeds, then traced runs, each
run a process of its own, and the spread of each end-to-end metric:

    python3 plexbench/sets.py --workload <cell> --seeds 11,13,17 \
        [--traced-seeds 7,9] [--seconds 51] [--out chiprun_out/sets]

Writes ``<out>/<cell>.jsonl`` (one line a run: set, seed, trace, exit code,
result line) and ``<out>/notes/`` (each run's standard error), and prints
each metric's spread per set: over all runs, and leaving out the run
farthest from the set's median. Stops at the first run that fails or is
not correct.
"""
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def one(cell: str, seed: int, seconds: float, trace: int, note: str):
    cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", cell,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace)]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    with open(note, "w") as f:
        f.write(p.stderr)
    lines = p.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if lines else None
    except ValueError:
        line = None
    return p.returncode, line


def spreads(values):
    """(spread of all, spread leaving out the run farthest from the
    median), each as a share of the median."""
    from plexbench.stats import spread
    if len(values) < 3:
        return None, None
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    rest = [v for i, v in enumerate(values) if i != far]
    return spread(values), spread(rest) if len(rest) >= 3 else None


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--traced-seeds", default="")
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "sets"))
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    traced = [int(s) for s in args.traced_seeds.split(",") if s]
    os.makedirs(os.path.join(args.out, "notes"), exist_ok=True)
    log = os.path.join(args.out, f"{args.workload}.jsonl")
    plan = [(k + 1, s, 0) for k in range(args.sets) for s in seeds]
    plan += [(1, s, 1) for s in traced]
    values = {}
    for n, seed, trace in plan:
        note = os.path.join(args.out, "notes",
                            f"{args.workload}.{n}.{seed}.{trace}.txt")
        rc, line = one(args.workload, seed, args.seconds, trace, note)
        row = {"set": n, "seed": seed, "trace": trace, "rc": rc,
               "line": line}
        with open(log, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
        if rc != 0 or not line or not line.get("correct"):
            print(f"stopped: run {n}/{seed}/{trace} rc {rc}", flush=True)
            return 1
        if not trace:
            for m, v in line["metrics"].items():
                values.setdefault((m, n), []).append(v["value"])
    for (m, n), vs in sorted(values.items()):
        whole, rest = spreads(vs)
        print(f"set {n} {m}: median {statistics.median(vs)!r} "
              f"spread {whole!r} without the farthest {rest!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
