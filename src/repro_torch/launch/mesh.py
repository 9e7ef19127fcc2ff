"""Device plane over ``torch.cuda`` devices: per-group device slices.

The :class:`DevicePlane` cuts the device list into one-device
:class:`MeshSlice`\\ s and leases them to node groups with the leasing rule
of ``repro.launch.mesh.DevicePlane``: the lowest free slice first, then the
least-loaded shared one. On one H100 every group shares the one slice, as
the JAX plane does on one device. The plane defaults to the CUDA devices
and raises when there are none; tests pass ``devices=[torch.device("cpu")]``.
Multi-device slices wait for the sharding port (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class MeshSlice:
    """A device leased to one or more node groups."""
    index: int
    device: torch.device


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
