"""Quickstart: the PlexRL public API on the port.

1. Build a model from the registry and run a GRPO ``update_actor``
   directly on a ``dummy_batch``.
2. Stand the same thing up as a serviceized deployment behind the Router
   and program it through the dataflow client API (the paper's §4.2
   interface): a bound ``Deployment`` handle whose methods return
   chainable futures — ``.then(fn)`` interposes client-side transforms,
   and passing a future as the next op's argument is the dependency edge.
3. The same chain against a live ``serve()`` plane: submit from client
   code while the dispatch workers run in the background.

The sizes are the reference's (``examples/quickstart.py``), head width 16
included.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
(on the CUDA card unless ``--device`` is given)
"""
import argparse
import time

import torch

from repro_torch.configs import ShapeSpec, reduced_config
from repro_torch.core import api
from repro_torch.core.router import Router
from repro_torch.launch.mesh import DevicePlane
from repro_torch.models.registry import build_model
from repro_torch.rl import grpo
from repro_torch.train import train_state as ts

HEAD_DIM = 16        # the reference's reduced config's


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    t0 = time.time()
    plane = DevicePlane(devices=None if args.device is None
                        else [torch.device(args.device)])
    dev = plane.slice_for_group(0).device

    # ------------------------------------------------------------ 1. direct
    cfg = reduced_config("qwen3-4b").replace(head_dim=HEAD_DIM)
    model = build_model(cfg)
    print(f"model {cfg.name}: {model.param_count():,} params (reduced)")
    gen = torch.Generator(device=dev).manual_seed(0)
    state = ts.init(model, gen, device=dev)
    batch = model.dummy_batch(torch.Generator(device=dev).manual_seed(1),
                              ShapeSpec("t", "train", 32, 8))
    state, metrics = grpo.make_update_actor(model)(state, batch)
    print("one update_actor:",
          {k: round(float(v), 4) for k, v in metrics.items()})

    # --------------------------------------------------------- 2. serviceized
    router = Router(device_plane=plane)
    spec = api.DeploymentSpec(
        deployment_id="demo-train", job_id="demo", model_name="qwen3-4b",
        role="train",
        overrides=tuple({"num_layers": 2, "d_model": 64, "num_heads": 4,
                         "num_kv_heads": 2, "head_dim": HEAD_DIM,
                         "d_ff": 128, "vocab_size": 128,
                         "attn_q_chunk": 32}.items()))
    dep = router.deploy(spec, group_id=0)          # bound client handle

    init_f = dep.init(seed=0)
    prompts = torch.randint(3, 128, (4, 8), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(2))
    # the dataflow chain: init gates generate through `after=` (ordering),
    # and `.then` interposes a client-side transform on the rollout result
    gen_f = dep.generate(prompts, max_new_tokens=8, after=(init_f,))
    count_f = gen_f.then(lambda g: int((g["tokens"] > 0).sum()))
    router.drain()                                 # admit + execute
    out = gen_f.result()
    print("generated:", tuple(out["tokens"].shape), "logprobs:",
          tuple(out["logprobs"].shape), "non-pad tokens:", count_f.result())
    print("state manager usage:", router.state_managers[0].usage())

    # ---------------------------------------------------- 3. serve-mode plane
    with router:                                   # serve() ... shutdown()
        out2 = dep.generate(prompts, max_new_tokens=8).wait(timeout=120)
    print("serve-mode generate:", tuple(out2["tokens"].shape))
    print(f"quickstart on {dev} took {time.time() - t0:.2f} s")


if __name__ == "__main__":
    main()
