"""What the per-layer metrics' readers share. A reader takes the run's
record and returns its number, or None where it finds nothing to read.

The record: ``spans`` (one a window op: job, op, submit, resolve, ok,
exec_s from the WPG's exec log, switch_s from the Router's switch log,
work, flops), ``switches`` (the switch log's entries of the window),
``window`` (its monotonic start and end), ``profile`` (a
``devtrace.DeviceTrace`` of a stretch of the window, or None), ``config``
and ``mix`` (the cell's files).
"""
from __future__ import annotations

import statistics
from typing import List, Optional

from plexbench import flops

K1_NAMES = ("flash_fwd_tc", "flash_fwd_kernel")
K2_NAMES = ("decode_split_tc", "decode_kernel")


def window_spans(rec) -> List[dict]:
    t0, t1 = rec.window
    return [s for s in rec.spans if s["ok"] and t0 <= s["submit"]
            and s["resolve"] <= t1]


def mean_exec(rec, op: str) -> Optional[float]:
    xs = [s["exec_s"] for s in window_spans(rec)
          if s["op"] == op and s.get("exec_s") is not None]
    return statistics.fmean(xs) if xs else None


def transitions(rec) -> List[dict]:
    """The switch log's entries that moved a job's state: the router also
    logs an op whose job was already resident, which moves nothing."""
    return [s for s in rec.switches
            if s["offload_bytes"] + s["load_bytes"] > 0]


def mean_switch(rec) -> Optional[float]:
    """Mean seconds (offload and load) of a change of job."""
    xs = [s["t_offload"] + s["t_load"] for s in transitions(rec)]
    return statistics.fmean(xs) if xs else None


def queue_wait(rec) -> Optional[float]:
    """Median over the window's ops of submit-to-resolve less the op's
    execution and the switch that loaded its job."""
    xs = [s["resolve"] - s["submit"] - s["exec_s"] - s["switch_s"]
          for s in window_spans(rec) if s.get("exec_s") is not None]
    return statistics.median(xs) if xs else None


def mfu(rec) -> Optional[float]:
    """Model FLOPs of the ops completed in the snapped window over its wall
    seconds at the card's peak, in %."""
    done = sorted((s["resolve"], s["flops"]) for s in window_spans(rec))
    if len(done) < 2 or done[-1][0] <= done[0][0]:
        return None
    work = sum(f for _, f in done[1:])
    return 100.0 * work / ((done[-1][0] - done[0][0]) * flops.PEAK_FLOPS)


def idle_share(rec) -> Optional[float]:
    tr = rec.profile
    if tr is None or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())


def k1_shape(rec):
    """(b, s, t, h, kh, d) of the cell's K1 launches: a train batch's
    forward (and its recompute), or a rollout's prefill."""
    cfg, mix = rec.config, rec.mix
    b = mix["prompts"] * mix["group"]
    s = mix["prompt_len"] + mix.get("response_len", 0)
    return (b, s, s, cfg["num_attention_heads"],
            cfg["num_key_value_heads"], cfg["head_dim"])


def k1_roofline(rec) -> Optional[float]:
    """K1's bound over its device time, in %: every K1 launch of the
    traced stretch has the cell's one shape."""
    tr = rec.profile
    if tr is None:
        return None
    ks = tr.matching(K1_NAMES)
    if not ks:
        return None
    per = flops.bound_s(*flops.k1(*k1_shape(rec)))
    return 100.0 * len(ks) * per / sum(d for _, _, d in ks)


def k2_positions(rec) -> List[int]:
    """The cache position of each K2 launch of the traced stretch, in
    order. A GENERATE's decode runs positions P .. P+N-1, each over every
    layer; its prefill's K1 launches come first. Launches after a prefill
    count up from P; those before the first prefill in the stretch (the
    tail of a GENERATE begun before tracing) count down to P+N-1."""
    tr = rec.profile
    cfg, mix = rec.config, rec.mix
    layers, p, n = (cfg["num_hidden_layers"], mix["prompt_len"],
                    mix["new_tokens"])
    events = sorted([(s, 1) for _, s, _ in tr.matching(K1_NAMES)]
                    + [(s, 2) for _, s, _ in tr.matching(K2_NAMES)])
    # runs of K2 launches, each with whether a prefill came before it
    runs, count, after_prefill = [], 0, False
    for _, kind in events:
        if kind == 1:
            if count:
                runs.append((count, after_prefill))
            count, after_prefill = 0, True
        else:
            count += 1
    if count:
        runs.append((count, after_prefill))
    out = []
    for m, after in runs:
        if after:
            out += [p + i // layers for i in range(m)]
        else:
            out += [p + n - 1 - (m - 1 - i) // layers for i in range(m)]
    return out


def k2_roofline(rec) -> Optional[float]:
    tr = rec.profile
    if tr is None:
        return None
    ks = tr.matching(K2_NAMES)
    if not ks:
        return None
    cfg, mix = rec.config, rec.mix
    b = mix["prompts"] * mix["group"]
    h, kh, d = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                cfg["head_dim"])
    bound = sum(flops.bound_s(*flops.k2(b, h, kh, d, pos))
                for pos in k2_positions(rec))
    return 100.0 * bound / sum(dur for _, _, dur in ks)
