"""End-to-end RLVR training driver.

Trains a model on the synthetic verifiable-math task with GRPO through the
whole stack (PlexCluster → Router + HRRS scheduler + StateManager + WPGs):
rollout -> verify -> update_actor, with optional multiplexing of several
jobs on one node group. Runs on the CUDA card unless ``--device cpu`` is
given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 50 --d-model 256 --layers 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --jobs 2 --layers 0 --d-model 0 --vocab 0   # the full config
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-3b-a800m --jobs 2

The size flags cut the config (0 keeps the config's own value); an MoE
config keeps its expert count, top-k and expert width. With
``--ckpt-dir`` every deployment's parameters are checkpointed there after
the run.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.cluster import PlexCluster
from repro_torch.core.controller import JobConfig
from repro_torch.launch.mesh import DevicePlane


def size_overrides(args) -> tuple:
    ov = []
    if args.layers:
        ov.append(("num_layers", args.layers))
    if args.d_model:
        ov.append(("d_model", args.d_model))
        ov.append(("num_heads", max(4, args.d_model // 64)))
        ov.append(("num_kv_heads", max(2, args.d_model // 128)))
        ov.append(("head_dim", 64))
        ov.append(("d_ff", args.d_model * 4))
    if args.vocab:
        ov.append(("vocab_size", args.vocab))
    return tuple(ov)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--group-size", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--jobs", type=int, default=1,
                    help="number of RLVR jobs multiplexed on the pool")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device for the group (default: the CUDA "
                         "devices)")
    args = ap.parse_args(argv)

    plane = DevicePlane(devices=None if args.device is None
                        else [torch.device(args.device)])
    cluster = PlexCluster(n_groups=1, device_plane=plane)
    ov = size_overrides(args)
    for j in range(args.jobs):
        cfg = JobConfig(
            job_id=f"job{j}", model_name=args.arch, steps=args.steps,
            batch_size=args.batch_size, group_size=args.group_size,
            max_new_tokens=args.max_new_tokens, seq_len=args.seq_len,
            overrides=ov, seed=j)
        cluster.add_job(cfg)

    t0 = time.time()
    billing = cluster.run(interleave=args.jobs > 1)
    elapsed = time.time() - t0

    for job_id, ctl in cluster.controllers.items():
        rewards = ctl.reward_log
        print(f"[{job_id}] steps={len(rewards)} "
              f"reward first5={np.round(rewards[:5], 3).tolist()} "
              f"last5={np.round(rewards[-5:], 3).tolist()} "
              f"mean={np.mean(rewards):.3f}")
        losses = [m["loss"] for m in ctl.metrics_log]
        rec = billing[job_id]
        print(f"[{job_id}] loss first={losses[0]:.4f} last={losses[-1]:.4f} "
              f"gpu_s/step={rec.gpu_seconds_per_step():.2f} "
              f"busy_s={rec.busy_seconds} switch_s={rec.switch_seconds}")
    print(f"wall={elapsed:.1f}s switches={len(cluster.router.switch_log)} "
          f"device={cluster.router.state_managers[0].device}")

    if args.ckpt_dir:
        paths = cluster.checkpoint_all(args.ckpt_dir)
        print("checkpoints:", json.dumps(paths, indent=1))


if __name__ == "__main__":
    main()
