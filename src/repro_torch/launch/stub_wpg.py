"""Spawnable stub WorkerProcessGroup for process-plane tests.

The port of ``repro.launch.stub_wpg``. It lives under ``src/`` because a
spawned group process imports its factory by name (the pipe carries
``"repro_torch.launch.stub_wpg:make_busy_wpg"``, never a pickled callable).
``needs_state_manager = False`` gives the child a light stand-in for the
StateManager, and nothing here imports torch, so a stub child spawns in a
fraction of a second.

Per-op kwargs drive its behaviour:

- ``busy_s``: burn CPU for that long in a pure-Python loop (a thread
  worker holds the GIL throughout);
- ``sleep_s``: a blocking sleep (releases the GIL);
- ``crash``: hard-exit the worker process mid-op (``os._exit``);
- ``fail``: raise inside ``execute`` (an op error, not a death);
- ``payload_mb`` / ``payload_kib``: return that much numpy array in the
  result (cached per size), so real bytes cross the reply path;
- ``stored_sum``: return the checksum of the last stored parameters (a
  cross-child weight sync landed);
- ``span``: return the op's start and end on the system-wide monotonic
  clock, so a test can tell whether two children's ops overlapped.

``make_crash_store_wpg`` builds a group whose store hard-exits: a child
dying mid-``sync_weights`` with shm descriptors in flight. ``sync_mb`` /
``sync_kib`` in the spec's overrides size ``host_params``.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict


class BusyWPG:
    """The WPG protocol surface, compute-bound on demand."""

    needs_state_manager = False

    def __init__(self, spec, sm):
        self.spec = spec
        self.sm = sm
        self.exec_log: list = []
        self._resident = True

    @property
    def job_prefix(self) -> str:
        return f"{self.spec.job_id}:{self.spec.deployment_id}"

    def resident(self) -> bool:
        return self._resident

    def ensure_resident(self) -> float:
        self._resident = True
        return 0.0

    def offload(self, to=None) -> float:
        self._resident = False
        return 0.0

    # ------------------------------------------------ weight-sync surface
    def host_params(self) -> Dict[str, Any]:
        """Deterministic host parameters sized by the spec's ``sync_mb``
        (MiB, default 1) or ``sync_kib``: what a cross-child sync exports.
        Cached, so repeated syncs time the transport."""
        params = getattr(self, "_host_params", None)
        if params is None:
            import numpy as np
            ov = dict(self.spec.overrides or ())
            kib = (int(ov["sync_kib"]) if "sync_kib" in ov
                   else int(ov.get("sync_mb", 1)) << 10)
            n = (kib << 10) // 4
            params = self._host_params = {"w": np.arange(n, dtype=np.float32)}
        return params

    def _store_params(self, tree) -> None:
        """Keep a copy: the leaves may be views over a segment that is
        recycled once the store returns."""
        import numpy as np
        self.stored = {k: np.array(v) for k, v in tree.items()}

    def execute(self, qop) -> Dict[str, Any]:
        t0 = time.monotonic()
        kw = qop.kwargs
        if kw.get("crash"):
            os._exit(43)
        if kw.get("fail"):
            raise RuntimeError(f"stub op {qop.req_id} asked to fail")
        busy = float(kw.get("busy_s", 0.0))
        if busy > 0.0:
            # spin against THREAD CPU time: a GIL-starved thread takes
            # proportionally longer wall time instead of finishing early
            deadline = time.thread_time() + busy
            x = 0
            while time.thread_time() < deadline:
                x += 1
        sleep = float(kw.get("sleep_s", 0.0))
        if sleep > 0.0:
            time.sleep(sleep)
        t1 = time.monotonic()
        out = {"op": qop.op.value, "req_id": qop.req_id, "pid": os.getpid(),
               "seconds": t1 - t0}
        if kw.get("span"):
            out["span"] = (t0, t1)
        kib = int(kw.get("payload_kib", 0)) + (int(kw.get("payload_mb", 0))
                                               << 10)
        if kib > 0:
            import numpy as np
            cache = getattr(self, "_payload_cache", None)
            if cache is None:
                cache = self._payload_cache = {}
            arr = cache.get(kib)
            if arr is None:
                arr = cache[kib] = np.arange((kib << 10) // 8,
                                             dtype=np.float64)
            out["data"] = arr
        if kw.get("stored_sum"):
            import numpy as np
            stored = getattr(self, "stored", None) or {}
            out["stored_sum"] = float(sum(
                np.asarray(v, np.float64).sum() for v in stored.values()))
        return out


class CrashStoreWPG(BusyWPG):
    """Dies inside its store: a target child crashing mid-sync while the
    source child's shm descriptors are in flight."""

    def _store_params(self, tree) -> None:
        os._exit(44)


def make_busy_wpg(spec, sm) -> BusyWPG:
    return BusyWPG(spec, sm)


make_busy_wpg.needs_state_manager = False


def make_crash_store_wpg(spec, sm) -> CrashStoreWPG:
    return CrashStoreWPG(spec, sm)


make_crash_store_wpg.needs_state_manager = False
