"""Model State Manager: per-node-group authority over tensor residency
(paper §4.5), the two tiers the serving path moves between:

    DEVICE  — tensors on the node group's device (its slice's device)
    HOST    — CPU tensors, pinned when the device is CUDA (async DMA)

Tensors are indexed by canonical logical key
(:func:`repro_torch.models.common.canonical_flat`), which deduplicates
replicas of one key. Offload and prefetch are timed and fed into
per-direction bandwidth EWMAs; HRRS reads its C_setup estimates from
``load_time_estimate`` / ``offload_time_estimate``. A CUDA copy returns
before its bytes have moved, so both transfers synchronize the device
before they read the clock: otherwise the times would be the enqueue, not
the copy. The DISK tier, capacity eviction, migration, weight sync and the
host optimizer step of ``repro.core.state_manager`` are not ported yet
(ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.models import common


class Tier(enum.IntEnum):
    DEVICE = 0
    HOST = 1


@dataclasses.dataclass
class Entry:
    key: str                         # canonical logical key (job-scoped)
    tier: Tier
    nbytes: int
    ref: torch.Tensor                # on the device (DEVICE) or the CPU (HOST)
    refcount: int = 1                # dedup count across logical replicas
    host: Optional[torch.Tensor] = None   # pinned buffer kept for reuse


class StateManager:
    """One instance per node group. Owns every byte of managed model state."""

    def __init__(self, node_id: str = "node0",
                 clock: Callable[[], float] = time.monotonic,
                 mesh_slice=None):
        self.node_id = node_id
        self.clock = clock
        # the node group's MeshSlice: DEVICE-tier tensors live on its device
        self.mesh_slice = mesh_slice
        self.entries: Dict[str, Entry] = {}
        self._bw_estimate: Dict[str, float] = {}   # bytes/s per direction

    @property
    def device(self) -> torch.device:
        return self.mesh_slice.device if self.mesh_slice is not None \
            else torch.device("cpu")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _record(self, direction: str, nbytes: int, dt: float):
        if dt > 0 and nbytes > 0:
            bw = nbytes / dt
            old = self._bw_estimate.get(direction)
            self._bw_estimate[direction] = bw if old is None else 0.7 * old + 0.3 * bw

    def _estimate(self, direction: str, nbytes: int, default_bw: float) -> float:
        bw = self._bw_estimate.get(direction, default_bw)
        return nbytes / max(bw, 1.0)

    # ----------------------------------------------------------- register
    def register(self, job_id: str, tree, tier: Tier = Tier.DEVICE,
                 prefix: str = "params") -> List[str]:
        """Adopt a tree of tensors under canonical keys. Re-registering an
        existing key only bumps its refcount (§4.5.2 replica dedup)."""
        keys = []
        for sub, leaf in common.canonical_flat(tree).items():
            key = f"{job_id}/{prefix}/{sub}"
            if key in self.entries:
                self.entries[key].refcount += 1
            else:
                self.entries[key] = Entry(
                    key=key, tier=tier,
                    nbytes=leaf.numel() * leaf.element_size(), ref=leaf)
            keys.append(key)
        return keys

    def keys_for(self, job_id: str, prefix: Optional[str] = None) -> List[str]:
        pre = f"{job_id}/" + (f"{prefix}/" if prefix else "")
        return [k for k in self.entries if k.startswith(pre)]

    def unregister(self, keys: Sequence[str]):
        for k in keys:
            e = self.entries.get(k)
            if e is None:
                continue
            e.refcount -= 1
            if e.refcount <= 0:
                del self.entries[k]

    # ------------------------------------------------------ tier movement
    def offload(self, keys: Sequence[str]) -> float:
        """Move DEVICE entries to HOST, into pinned buffers reused across
        switches. Returns elapsed seconds, read off the injected clock after
        the device has finished the copies."""
        self._sync()
        t0 = self.clock()
        moved = 0
        for k in keys:
            e = self.entries.get(k)
            # a key may vanish mid-iteration when a deployment detaches
            if e is None or e.tier == Tier.HOST:
                continue
            t = e.ref
            if t.device.type != "cpu":
                if e.host is None or e.host.shape != t.shape \
                        or e.host.dtype != t.dtype:
                    e.host = torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=True)
                e.host.copy_(t, non_blocking=True)
                e.ref = e.host
            e.tier = Tier.HOST
            moved += e.nbytes
        self._sync()
        dt = self.clock() - t0
        self._record("offload", moved, dt)
        return dt

    def prefetch(self, keys: Sequence[str]) -> float:
        """Move HOST entries up to DEVICE (scheduler-directed prefetch).
        Timed like :meth:`offload`."""
        self._sync()
        t0 = self.clock()
        moved = 0
        for k in keys:
            e = self.entries.get(k)
            if e is None or e.tier == Tier.DEVICE:
                continue
            e.ref = e.ref.to(self.device, non_blocking=True)
            e.tier = Tier.DEVICE
            moved += e.nbytes
        self._sync()
        dt = self.clock() - t0
        self._record("load", moved, dt)
        return dt

    # --------------------------------------------------------- estimates
    def load_time_estimate(self, nbytes: int) -> float:
        return self._estimate("load", nbytes, 1e10)

    def offload_time_estimate(self, nbytes: int) -> float:
        return self._estimate("offload", nbytes, 1e10)

    def job_bytes(self, job_id: str) -> int:
        return sum(e.nbytes for k, e in self.entries.items()
                   if k.startswith(f"{job_id}/"))

    # ------------------------------------------------------- gather trees
    def gather(self, job_id: str, template, prefix: str = "params"):
        """Rebuild a tree from managed entries (HOST entries stay on the
        CPU)."""
        pre = f"{job_id}/{prefix}/"
        flat = {k[len(pre):]: e.ref for k, e in self.entries.items()
                if k.startswith(pre)}
        return common.canonical_unflatten(template, flat)
