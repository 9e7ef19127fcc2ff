"""End-to-end driver: train a ~100M-param qwen2-family model with GRPO on
the synthetic verifiable-math task through the full PlexRL service stack,
checkpointing every deployment after the run (the port of
``examples/train_100m.py``, at its sizes).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 200]
      [--device cpu] [--ckpt-dir DIR]
(on the CUDA card unless ``--device`` is given; on the CPU, ~100M params
is slow: --steps 2 for a quick pass. The driver is the port's
``repro_torch.launch.train``.)
"""
import argparse
import os
import tempfile

from repro_torch.launch import train as train_driver


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "plexrl_100m"))
    args = ap.parse_args(argv)
    # ~100M params: 12 layers x d_model 640 x vocab 4096
    train_driver.main([
        "--arch", "qwen2-0.5b",
        "--steps", str(args.steps),
        "--layers", "12",
        "--d-model", "640",
        "--vocab", "4096",
        "--batch-size", "16",
        "--group-size", "4",
        "--max-new-tokens", "24",
        "--seq-len", "96",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "50",
    ] + ([] if args.device is None else ["--device", args.device]))


if __name__ == "__main__":
    main()
