"""The readings the check's limits are set from, over many seeds in one
process (the benchmark's own runs never run this):

- the program: the numbers a run compares, through the run's own set-up and
  ops at the cell's sizes (a rollout cell runs each job's GENERATEs until
  one of each kind, greedy and sampled, has finished);
- the control: the reference put in the program's place, computed in fp8
  (e4m3 inputs to every matrix product), judged by the same comparison;
- for a training cell, the fault "half of the batch left out, the mean
  taken over the rest": the reference on the first half of each batch's
  rows in the program's place.

    python3 plexbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--out chiprun_out/calibrate.json]

One JSON line a seed goes to standard output and the whole to ``--out``.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path.pop(0)
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def controls(sess, ref_readings) -> dict:
    """The control's (and a training cell's half-batch fault's) numbers,
    against the f32 reference's readings of the same seed."""
    import torch
    from plexbench import weights as wts
    if sess.mix["kind"] == "train":
        out = {"control_fp8": sess.compare(sess.reference("fp8"),
                                           ref_readings)}
        half = sess.reference(
            "f32", rows=slice(0, sess.rows // 2))
        half["logp0"] = ref_readings["logp0"]
        out["fault_half_batch"] = sess.compare(half, ref_readings)
        return out
    sample = sess.last_sample
    ctrl = []
    for s in sample:
        w = wts.make_weights(sess.cfg, sess.seed, s["job"], sess.device)
        lg = sess.reference_logits([s], w, "fp8")[0]
        del w
        c = dict(s)
        if s["greedy"]:
            c["tokens"] = lg.argmax(dim=-1)
        else:
            c["logprobs"] = torch.log_softmax(lg, dim=-1).gather(
                -1, s["tokens"][..., None])[..., 0]
        ctrl.append(c)
    # the control's tokens judged by the f32 reference's logits
    return {"control_fp8": sess.compare(ctrl, sess.last_logits)}


def one_seed(cell, seed: int, with_controls: bool, device: str,
             cluster_kwargs=None) -> dict:
    import gc
    import torch
    from plexbench.harness import Window
    sess = cell.module("kinds").Session(cell, seed, device, cluster_kwargs)
    t0 = time.monotonic()
    sess.setup()
    t_setup = time.monotonic() - t0
    if sess.mix["kind"] == "rollout":
        temps = [t <= 0 for t in sess.mix["temperature"]]
        win = Window(sess, 3600.0, False,
                     ops=1 + max(temps.index(True), temps.index(False)))
        win.run()
        sess.after_window(win)
    sess.free()
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    t1 = time.monotonic()
    numbers = sess.check(None)
    out = {"seed": seed, "program": numbers, "setup_s": t_setup,
           "check_s": time.monotonic() - t1}
    ref = getattr(sess, "last_ref", None)
    if ref is not None:
        # leaves the change's comparison leaves out by the rule on the
        # reference's gradient
        moving = set(sess.ref.moving_leaves(ref["raw_grad1"]))
        out["static_leaves"] = sorted(set(ref["raw_grad1"]) - moving)
    if with_controls:
        t2 = time.monotonic()
        out.update(controls(sess, getattr(sess, "last_ref", None)))
        out["controls_s"] = time.monotonic() - t2
    return out


def main(argv=None) -> int:
    import argparse
    import json
    from plexbench.harness import Cell, forbidden_modules, require_cards
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    require_cards(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in seeds:
        row = one_seed(cell, seed, seed in ctrl, "cuda:0")
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    bad = forbidden_modules()
    if bad:
        print("jax or the JAX package was loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
