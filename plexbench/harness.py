"""One run of one cell: set-up, the measured window, the check of what the
timed path produced, and the result line.

Everything a cell is made of is found by name under ``plexbench/``:

- ``BENCHMARK.json``'s workload names a configuration and a traffic mix;
- ``configs/<config>.json`` (the file BENCHMARK.json gives) holds the
  model's sizes, its registry name in the port and its family;
- ``traffic/<mix>.json`` holds the mix; its ``kind`` names the session
  module ``kinds/<kind>.py`` that drives it;
- ``reference/<family>.py`` and ``port/<family>.py`` hold the family's plain
  reference and the mapping of its weights onto the port's tree;
- ``metrics/<metric>.py`` reads one per-layer metric from the run's record;
- ``limits/<cell>.json`` holds the limit of each number the check compares.

The window: one client thread a job, each calling the service API in a
closed loop (submit, wait for the future, submit the next); ops run on the
port's ``PlexCluster`` (Router -> HRRS -> StateManager switches -> WPG ->
model -> kernels) with its persistent dispatch plane serving.
"""
from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import ModuleType
from typing import List, Optional

PB = Path(__file__).resolve().parent
REPO = PB.parent
# an answer may come this long after the window closes and still count
LATE_S = 60.0
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    pass


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A module from a file of the harness, by path (its name may hold
    dots: ``metrics/mfu.train.py``); one module a file."""
    path = path.resolve()
    tag = hashlib.sha1(str(path).encode()).hexdigest()[:12]
    name = "plexbench_{}_{}_{}".format(
        path.parent.name, path.stem.replace(".", "_").replace("-", "_"), tag)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    def __init__(self, name: str, bench: Optional[dict] = None,
                 root: Path = REPO, data: Path = PB):
        bench = bench if bench is not None else load_json(
            root / "BENCHMARK.json")
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                           f"{sorted(work)}")
        self.name = name
        self.data = data
        self.workload = work[name]
        self.chips = self.workload["chips"]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic_name = self.workload["traffic"]
        self.traffic = load_json(data / "traffic" / f"{self.traffic_name}.json")
        self.family = self.config["family"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        limits = data / "limits" / f"{name}.json"
        self.limits = load_json(limits)["limits"] if limits.exists() else {}

    def module(self, kind: str) -> ModuleType:
        """``kinds``, ``reference`` or ``port``: the module this cell's mix
        or family names."""
        key = self.traffic["kind"] if kind == "kinds" else self.family
        return load_module(self.find(kind, key))

    def metric_reader(self, metric: str) -> ModuleType:
        return load_module(self.find("metrics", metric))

    def find(self, kind: str, name: str) -> Path:
        """``<kind>/<name>.py`` under the cell's data directory, else the
        harness's own."""
        path = self.data / kind / f"{name}.py"
        return path if path.exists() else PB / kind / f"{name}.py"


def process_start() -> float:
    """The process's start on ``time.monotonic``'s clock (from /proc where
    it is there, else now)."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return now


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def require_cards(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the cell "
                       f"needs {chips}")


class SmiSampler:
    """``nvidia-smi`` sampling the card's clocks and power once a second
    while the window runs."""

    QUERY = "clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"

    def __init__(self):
        self.proc = None
        self.rows: List[List[float]] = []

    def start(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}", "-i", "0",
                 "--format=csv,noheader,nounits", "-lms", "1000"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self):
        if self.proc is None:
            return
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        for line in out.splitlines():
            try:
                self.rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue

    def summary(self) -> dict:
        if not self.rows:
            return {}
        cols = list(zip(*self.rows))
        names = self.QUERY.split(",")
        return {n: [min(c), sorted(c)[len(c) // 2], max(c)]
                for n, c in zip(names, cols)}


class HostLoad:
    """The host's load over the window, from ``/proc/stat`` (every CPU the
    machine shows: the share busy, and the share stolen by its host) and
    this process's own CPU seconds (``os.times``)."""

    def __init__(self):
        self.start = self.end = None

    @staticmethod
    def read():
        try:
            with open("/proc/stat") as f:
                cpu = [float(x) for x in f.readline().split()[1:]]
        except (OSError, ValueError):
            cpu = None
        t = os.times()
        return cpu, t.user + t.system, time.monotonic()

    def mark(self):
        if self.start is None:
            self.start = self.read()
        else:
            self.end = self.read()

    def summary(self) -> dict:
        if self.start is None or self.end is None:
            return {}
        (c0, p0, t0), (c1, p1, t1) = self.start, self.end
        out = {"process_cpu_s": p1 - p0, "wall_s": t1 - t0,
               "cpus": os.cpu_count()}
        if c0 and c1:
            d = [b - a for a, b in zip(c0, c1)]
            total = sum(d[:8]) or 1.0
            # user nice system idle iowait irq softirq steal
            out["busy_share"] = 1.0 - (d[3] + d[4]) / total
            out["steal_share"] = d[7] / total if len(d) > 7 else None
        try:
            out["loadavg"] = os.getloadavg()
        except OSError:
            pass
        return out


def alloc_retries(torch) -> int:
    return int(torch.cuda.memory_stats(0).get("num_alloc_retries", 0))


def card_identity(torch) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "-i", "0",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.strip()
        info["power_limit_w"] = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


class Window:
    """The measured window: a client thread a job, each in a closed loop
    on ``session.submit``. With ``ops`` set, each client stops after that
    many ops instead of at the window's end (set-up's first steps, by the
    window's own clients)."""

    def __init__(self, session, seconds: float, trace: bool,
                 ops: Optional[int] = None):
        """``trace``: trace the card over a stretch of the window (only
        where the session runs on a card)."""
        self.session = session
        self.seconds = seconds
        self.ops = ops
        self.trace = trace and session.device.type == "cuda"
        self.spans: List[dict] = []
        self.lock = threading.Lock()
        self.done = threading.Condition(self.lock)
        self.tracer = None

    def client(self, job: int):
        k = 0
        while True:
            t = time.monotonic()
            if t >= self.t1 or (self.ops is not None and k >= self.ops):
                return
            fut, span = self.session.submit(job, k)
            span.update(job=job, k=k, submit=t)
            try:
                res = fut.wait(timeout=max(1.0, self.t1 + LATE_S
                                           - time.monotonic()))
                span["resolve"] = time.monotonic()
                span["ok"] = True
                self.session.keep(job, k, span, res)
            except Exception as e:  # noqa: BLE001 - counted as failed
                span["resolve"] = time.monotonic()
                span["ok"] = False
                span["error"] = repr(e)[:300]
            with self.done:
                self.spans.append(span)
                self.done.notify_all()
            if not span["ok"]:
                return
            k += 1

    def run(self):
        from plexbench.devtrace import DeviceTrace
        self.t0 = time.monotonic()
        self.t1 = self.t0 + self.seconds
        threads = [threading.Thread(target=self.client, args=(j,),
                                    name=f"client{j}", daemon=True)
                   for j in range(self.session.jobs)]
        for t in threads:
            t.start()
        if self.trace:
            # start at an op's completion, once the window has run a while
            after = self.t0 + self.session.mix["trace_after"] * self.seconds
            time.sleep(max(0.0, after - time.monotonic()))
            with self.done:
                n = len(self.spans)
                self.done.wait_for(lambda: len(self.spans) > n,
                                   timeout=max(0.0, self.t1 - time.monotonic()))
            if time.monotonic() < self.t1:
                self.tracer = DeviceTrace()
                self.tracer.start()
        if self.ops is None:
            time.sleep(max(0.0, self.t1 - time.monotonic()))
        if self.tracer is not None:
            self.tracer.stop()
        for t in threads:
            t.join(timeout=max(0.0, self.t1 - time.monotonic()) + LATE_S
                   + 30)
        self.stragglers = [t.name for t in threads if t.is_alive()]


def exec_by_job(record) -> dict:
    """Each job's op times in the window by kind of op: [count, mean, min,
    max] seconds of execution."""
    from plexbench import readers
    groups: dict = {}
    for s in readers.window_spans(record):
        if s.get("exec_s") is not None:
            key = f"job{s['job']} {s['op']} {s.get('label', '')}".strip()
            groups.setdefault(key, []).append(s["exec_s"])
    return {k: [len(v), sum(v) / len(v), min(v), max(v)]
            for k, v in sorted(groups.items())}


def label_at(record, t: float) -> str:
    """What the host was doing at time ``t`` of the window, by the run's
    spans: a switch, an op executing, or neither (dispatch and queues)."""
    for s in record.switches:
        end = s["t"]
        if end - s["t_offload"] - s["t_load"] <= t <= end:
            return f"switch to {s['to_job']}"
    for s in record.spans:
        if s.get("exec_s") is None:
            continue
        if s["resolve"] - s["exec_s"] <= t <= s["resolve"]:
            return f"job{s['job']} {s['op']} executing"
    return "no op executing (client, dispatch, queue)"


class Run:
    """One run of one cell, from set-up to the result line."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda:0", t_start: Optional[float] = None,
                 cluster_kwargs: Optional[dict] = None):
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t_start = process_start() if t_start is None else t_start
        self.cluster_kwargs = cluster_kwargs or {}

    def execute(self) -> dict:
        import torch
        from plexbench import devtrace, readers, stats
        on_card = self.device.startswith("cuda")
        sess = self.cell.module("kinds").Session(
            self.cell, self.seed, self.device, self.cluster_kwargs)
        sess.setup()
        win = Window(sess, self.seconds, self.trace)
        smi = SmiSampler() if on_card else None
        if smi:
            smi.start()
        host = HostLoad()
        host.mark()
        retries = alloc_retries(torch) if on_card else 0
        t_setup = time.monotonic()
        setup_s = t_setup - self.t_start
        win.run()
        if smi:
            smi.stop()
        host.mark()
        if on_card:
            retries = alloc_retries(torch) - retries
        peak = torch.cuda.max_memory_allocated(0) if on_card else 0
        record = sess.after_window(win)
        record.window = (win.t0, win.t1)
        record.profile = win.tracer
        record.cell, record.config, record.mix = (
            self.cell.name, self.cell.config, self.cell.traffic)
        sess.free()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        bad = forbidden_modules()
        if bad:
            raise RuntimeError("modules of jax or the JAX package are loaded: "
                               + ", ".join(bad))
        numbers = sess.check(record)
        spans = record.spans
        inside = [s for s in spans if s["submit"] >= win.t0]
        failed = [s for s in inside if not s["ok"]]
        done = [(s["resolve"], s["work"]) for s in inside
                if s["ok"] and s["resolve"] <= win.t1]
        metrics = {}
        if not self.trace:
            values = {"setup_s": setup_s}
            rate = stats.snapped_rate(done)
            if rate is not None:
                values[sess.rate_metric] = rate
            lat = [s["resolve"] - s["submit"] if s["ok"] else math.inf
                   for s in inside]
            if lat:
                values["op_latency_p90_s"] = stats.percentile(lat, 0.9)
            for m in self.cell.end_to_end:
                if m["name"] in values:
                    metrics[m["name"]] = {"value": values[m["name"]],
                                          "unit": m["unit"]}
        else:
            for m in self.cell.per_layer:
                value = self.cell.metric_reader(m["name"]).read(record)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        checks = {}
        correct = not failed and not win.stragglers and bool(done)
        for name, value in numbers.items():
            limit = self.cell.limits.get(name)
            ok = limit is not None and math.isfinite(value) and value <= limit
            correct = correct and ok
            checks[name] = {"value": value, "limit": limit}
        device = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_card
                  else "cpu", "count": self.cell.chips if on_card else 0,
                  "memory_peak_bytes": peak}
        if on_card:
            device.update(card_identity(torch))
        result = {"correct": correct, "attempted": len(inside),
                  "failed": len(failed), "metrics": metrics,
                  "device": device}
        tr = win.tracer
        if self.trace and tr is not None:
            device["busy_s"] = tr.busy_s()
            device["window_s"] = tr.window_s()
            result["breakdown"] = {
                "device_ops": devtrace.top_ops(tr),
                "idle_gaps": devtrace.labelled_gaps(
                    tr, lambda t: label_at(record, t))}
        result["checks"] = checks
        self.notes = {
            "setup_s": setup_s, "ops_in_window": len(inside),
            "completed_in_window": len(done),
            "per_job": {j: sum(1 for s in inside if s["job"] == j)
                        for j in range(sess.jobs)},
            "clocks": smi.summary() if smi else {},
            "stragglers": win.stragglers,
            "errors": [s["error"] for s in failed][:3],
            "trace": devtrace.clip_note(tr),
            # where the window's time went, in every run (the per-layer
            # metrics read the same spans in the traced run only)
            "host": host.summary(),
            # the caching allocator's frees and retries of a failed
            # allocation inside the window (each synchronizes the card)
            "alloc_retries": retries,
            "exec_s_by_job": exec_by_job(record),
            "exec_mean_s": {op: readers.mean_exec(record, op)
                            for op in sorted({s["op"] for s in spans})},
            "switches": len(readers.transitions(record)),
            "switch_mean_s": readers.mean_switch(record),
        }
        return result


def report(result: dict, notes: dict, out=None, err=None):
    """The notes and the compared numbers on standard error (the numbers
    last), then the result as the last line of standard output."""
    out = out or sys.stdout
    err = err or sys.stderr
    for k, v in notes.items():
        print(f"{k}: {v}", file=err)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a non-negative whole number")
    cell = Cell(args.workload)
    try:
        require_cards(cell.chips)
    except NoDevice as e:
        print(f"plexbench: {e}", file=sys.stderr)
        return 2
    run = Run(cell, args.seed, args.seconds, bool(args.trace),
              t_start=t_start)
    result = run.execute()
    bad = forbidden_modules()
    if bad:
        print("plexbench: jax or the JAX package was loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    report(result, run.notes)
    return 0
