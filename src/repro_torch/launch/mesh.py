"""Device plane over ``torch.cuda`` devices: per-group device slices.

The :class:`DevicePlane` cuts the device list into one-device
:class:`MeshSlice`\\ s and leases them to node groups with the leasing rule
of ``repro.launch.mesh.DevicePlane``: the lowest free slice first, then the
least-loaded shared one. On one H100 every group shares the one slice, as
the JAX plane does on one device; a retired group returns its lease
(:meth:`DevicePlane.release`). The plane defaults to the CUDA devices
and raises when there are none; tests pass ``devices=[torch.device("cpu")]``.
Multi-device slices wait for the sharding port (ROADMAP.md, Queue 1).

:data:`HW` holds the card's datasheet peaks, the cost model's constants
(``launch/dryrun.py``) and those of ``chip_smoke.py``'s bound column
(:func:`bound`). :func:`make_production_mesh` exists only to say that a
multi-device mesh is not ported.

:func:`env_for_slice` and :func:`device_for_slice` give a process-plane
child (``launch/proc_plane.py``) its view of a slice: a CUDA slice is the
only card the child sees, as its ``cuda:0``.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, List, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class MeshSlice:
    """A device leased to one or more node groups."""
    index: int
    device: torch.device


def env_for_slice(sl: MeshSlice) -> Dict[str, str]:
    """The environment that makes a spawned group process see exactly its
    slice's device: ``CUDA_VISIBLE_DEVICES`` set to the slice's card, which
    the child then sees as ``cuda:0``. A CPU slice (the tests) hides every
    card. Applied in the child before torch initialises CUDA."""
    if sl.device.type == "cuda":
        idx = 0 if sl.device.index is None else sl.device.index
        return {"CUDA_VISIBLE_DEVICES": str(idx)}
    return {"CUDA_VISIBLE_DEVICES": ""}


def device_for_slice(sl: MeshSlice) -> str:
    """The device a group process runs on, as a plain string for its
    config (unpickling a ``torch.device`` would import torch before the
    environment is applied): ``"cuda:0"`` under :func:`env_for_slice`'s
    mask, else the slice's own device type."""
    return "cuda:0" if sl.device.type == "cuda" else sl.device.type


def host_shm_bytes(path: str = "/dev/shm") -> Optional[int]:
    """Free bytes in the host's POSIX shared-memory filesystem, or ``None``
    where it does not exist. tmpfs backs only the pages written, so a
    segment larger than this is created without complaint and a write past
    the free bytes is a SIGBUS in the writer: check before a large move."""
    try:
        st = os.statvfs(path)
    except OSError:
        return None
    return st.f_bavail * st.f_frsize


# NVIDIA H100 80GB HBM3 (SXM), 700 W, from NVIDIA's datasheet: dense bf16
# tensor-core rate (no sparsity), HBM3 bandwidth and capacity. One card has
# no collectives, so no interconnect term (the collective term is 0).
HW = {
    "name": "NVIDIA H100 80GB HBM3 (SXM), 700 W",
    "peak_flops_bf16": 989e12,     # FLOP/s
    "hbm_bw": 3.35e12,             # bytes/s
    "hbm_bytes": 80e9,             # bytes
}


def bound(nbytes: float, flops: float):
    """The least ms the card can take for work that moves ``nbytes`` and
    does ``flops`` bf16 operations, and which of the two bounds it:
    ``(ms, "bytes" | "operations")``."""
    t_bytes = nbytes / HW["hbm_bw"] * 1e3
    t_ops = flops / HW["peak_flops_bf16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 256- and 512-chip meshes: not ported, one H100 runs
    only the one-device case."""
    raise NotImplementedError(
        "a multi-device mesh is not ported yet (ROADMAP.md, Queue 1: item "
        "5, sharding)")


class DevicePlane:
    """Cuts the devices into slices and leases them to node groups."""

    def __init__(self, devices: Optional[Sequence] = None):
        self._devices = None if devices is None \
            else [torch.device(d) for d in devices]
        self._slices: Optional[List[MeshSlice]] = None
        self._owner: Dict[int, int] = {}      # group id -> slice index
        self._holders: Dict[int, int] = {}    # slice index -> lease count
        self._lock = threading.Lock()

    def _slices_locked(self) -> List[MeshSlice]:
        if self._slices is None:
            devs = self._devices
            if devs is None:
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "DevicePlane: no CUDA device; pass devices=[torch."
                        "device('cpu')] to run on the CPU")
                devs = [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
            self._slices = [MeshSlice(i, d) for i, d in enumerate(devs)]
        return self._slices

    def slice_for_group(self, group_id: int) -> MeshSlice:
        """The slice leased to ``group_id`` (leasing one if needed)."""
        with self._lock:
            slices = self._slices_locked()
            idx = self._owner.get(group_id)
            if idx is None:
                # the lowest free slice, else share the least-loaded one
                idx = min(slices, key=lambda s: (
                    self._holders.get(s.index, 0), s.index)).index
                self._owner[group_id] = idx
                self._holders[idx] = self._holders.get(idx, 0) + 1
            return slices[idx]

    def release(self, group_id: int):
        """Return ``group_id``'s lease (a retired group)."""
        with self._lock:
            idx = self._owner.pop(group_id, None)
            if idx is not None:
                self._holders[idx] = max(0, self._holders.get(idx, 1) - 1)

    def slice_index(self, group_id: int) -> Optional[int]:
        with self._lock:
            return self._owner.get(group_id)

    def domains(self) -> Dict[int, int]:
        """group id -> slice index for every leased group (the placement
        layer's mesh-domain map: moves across domains pay the copy)."""
        with self._lock:
            return dict(self._owner)
