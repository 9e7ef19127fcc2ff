"""Batched serving driver: prefill + decode loop through the service API.

The rollout side of PlexRL as a standalone deployment on a LIVE serve-mode
plane: the Router's dispatch worker parks while idle, admits each batched
generate the moment it is submitted, and the client blocks on the returned
future. Runs on the CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --batch 8 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --full-width \\
        --batch 16 --prompt-len 128 --max-new 64     # unmodified qwen2-0.5b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
        --full-width --batch 16 --prompt-len 512 --max-new 64
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import api
from repro_torch.core.router import Router
from repro_torch.launch.mesh import DevicePlane
from repro_torch.rl import data as data_lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--full-width", action="store_true",
                    help="deploy the unmodified config (ignores --layers "
                         "and --d-model)")
    ap.add_argument("--device", default=None,
                    help="torch device for the group (default: the CUDA "
                         "devices)")
    args = ap.parse_args(argv)

    # a narrow, shallow cut of the config: the ssm family keeps its SSD
    # head width and state (only d_model, and with it the head count, shrinks)
    overrides = () if args.full_width else (
        ("num_layers", args.layers), ("d_model", args.d_model),
        ("vocab_size", 512))
    if not args.full_width and get_config(args.arch).family != "ssm":
        overrides += (
            ("num_heads", max(4, args.d_model // 64)),
            ("num_kv_heads", max(2, args.d_model // 128)),
            ("head_dim", 64), ("d_ff", args.d_model * 4))
    plane = DevicePlane(devices=None if args.device is None
                        else [torch.device(args.device)])
    router = Router(device_plane=plane)
    spec = api.DeploymentSpec(deployment_id="serve", job_id="serve",
                              model_name=args.arch, role="rollout",
                              overrides=overrides)
    dep = router.deploy(spec, group_id=0)

    ds = data_lib.MathDataset(seed=0)
    batches = ds.batches(args.batch, args.prompt_len)
    lat = []
    with router:                      # persistent plane: serve()...shutdown()
        dep.init(seed=0).wait(timeout=600)
        for r in range(args.rounds):
            prompts, _ = next(batches)
            t0 = time.time()
            out = dep.generate(prompts, max_new_tokens=args.max_new,
                               temperature=0.7).wait(timeout=600)
            dt = time.time() - t0
            lat.append(dt)
            toks = int(out["alive"].sum())
            print(f"round {r}: {dt*1000:.0f} ms, {toks} live tokens, "
                  f"{toks / dt:.1f} tok/s, sample: "
                  f"{data_lib.decode(out['tokens'][0].tolist())!r}")
    print(f"mean latency {np.mean(lat)*1000:.0f} ms (first includes the "
          f"kernel build on a card)")


if __name__ == "__main__":
    main()
