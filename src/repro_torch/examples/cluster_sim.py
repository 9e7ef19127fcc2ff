"""Cluster-scale what-if: replay a 3-month-style job mix through the four
scheduling policies and print the Fig. 8 numbers (delay CDF percentiles,
makespan ratio, effective capacity gain).

The port of ``examples/cluster_sim.py``: the simulator is host code (numpy),
so it needs no device, and it prints the same text for the same arguments.

Run:  PYTHONPATH=src python -m repro_torch.examples.cluster_sim [--jobs 64] [--nodes 32]
"""
import argparse

import numpy as np

from repro_torch.core.simulator import run_policy_comparison
from repro_torch.core.traces import synthetic_job_mix


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=48)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--nodes", type=int, default=32)
    ap.add_argument("--group-size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args(argv)

    profiles = synthetic_job_mix(args.jobs, seed=args.seed)
    res = run_policy_comparison(
        profiles, steps=args.steps, arrival_rate=1 / 90.0, seed=args.seed,
        total_nodes=args.nodes, group_size=args.group_size)

    iso = res["isolated"].makespan
    print(f"{'policy':18s} {'p50':>8s} {'p90':>8s} {'p99':>8s} "
          f"{'makespan':>10s} {'vs iso':>7s} {'util':>6s}")
    for pol, r in res.items():
        d = r.norm_delays()
        print(f"{pol:18s} {np.percentile(d, 50):8.3f} "
              f"{np.percentile(d, 90):8.3f} {np.percentile(d, 99):8.3f} "
              f"{r.makespan:9.0f}s {r.makespan / iso:7.2%} "
              f"{r.utilization():6.1%}")
    sb = res["spread_backfill"]
    print(f"\neffective capacity gain (iso makespan / spread+backfill): "
          f"{iso / sb.makespan:.2f}x   (paper: ~1.8x)")


if __name__ == "__main__":
    main()
