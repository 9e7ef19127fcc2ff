"""Device plane over ``torch.cuda`` devices: per-group mesh slices.

The :class:`DevicePlane` cuts the device list into disjoint
:class:`MeshSlice`\\ s (``slice_size`` devices each, else one) and leases
them to node groups with the leasing rule of
``repro.launch.mesh.DevicePlane``: the lowest free slice first, then the
least-loaded shared one; a retired group returns its lease
(:meth:`DevicePlane.release`). A slice's :class:`Mesh` is a (1, n)
``data`` x ``model`` grid, over which its groups lay their state out
(``models/sharding.py``) and run tensor-parallel (``models/layers.py``).

One process drives every device of a slice, as JAX does; no
``torch.distributed`` group is made (NCCL refuses two ranks on one card).
A device list may repeat a device: ``[torch.device("cuda", 0)] * 4`` is
four *virtual* devices on one card, as XLA's
``--xla_force_host_platform_device_count`` gives N virtual CPU devices.
A device's id is its position in the plane's list
(:meth:`MeshSlice.device_ids`), so virtual devices stay distinct. The
plane defaults to the CUDA devices and raises when there are none; tests
pass ``devices=[torch.device("cpu")] * 8``. Virtual devices exist only
where the caller lists them.

:data:`HW` holds the card's datasheet peaks, the cost model's constants
(``launch/dryrun.py``) and those of ``chip_smoke.py``'s bound column
(:func:`bound`). :func:`make_production_mesh` builds the reference's 256-
and 512-device meshes, on ``meta`` devices unless given others: the dry
run counts their per-device work there.

:func:`env_for_slice` and :func:`devices_for_slice` give a process-plane
child (``launch/proc_plane.py``) its view of its slice, of one device or
several: ``CUDA_VISIBLE_DEVICES`` over the slice's distinct cards, in
order, and one device string per device of the slice in the child's
numbering (cards 2 and 3 become ``cuda:0`` and ``cuda:1``; four virtual
devices on card 0 become ``cuda:0`` four times). With the slice's device
ids the child builds the parent's :class:`MeshSlice` over its own
devices.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch



class Mesh:
    """A grid of devices with axis names (``repro``'s ``jax.sharding.Mesh``):
    ``devices`` and ``device_ids`` are numpy object / int arrays of the
    grid's shape, ``shape`` maps each axis name to its size. Two meshes
    are equal when their axes, devices and ids are."""

    def __init__(self, devices, axis_names: Sequence[str], ids=None):
        arr = np.empty(np.shape(np.asarray(devices, dtype=object)),
                       dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[idx] = torch.device(d)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-D device grid for axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.device_ids = np.arange(arr.size).reshape(arr.shape) \
            if ids is None else np.asarray(ids, dtype=np.int64).reshape(
                arr.shape)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))
        self.size = int(arr.size)

    def flat_devices(self) -> List[torch.device]:
        """The devices in row-major order: the order of a sharded value's
        local tensors."""
        return list(self.devices.flat)

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat),
                tuple(int(i) for i in self.device_ids.flat))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]}, ids="
                f"{[int(i) for i in self.device_ids.flat]})")


def _slice_mesh(devices: Sequence, ids: Sequence[int]) -> Mesh:
    """A (1, n) data x model mesh over exactly the devices it was carved
    with."""
    return Mesh([list(devices)], ("data", "model"), [list(ids)])


@dataclasses.dataclass(frozen=True)
class MeshSlice:
    """A disjoint subset of the plane's devices with its own mesh.

    ``MeshSlice(index, device)`` (one device, no mesh) stays valid: the
    devices become a one-tuple and the mesh is built over them, with ids
    from 0."""
    index: int
    devices: Tuple
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        devs = self.devices
        if isinstance(devs, (torch.device, str)):
            devs = (devs,)
        devs = tuple(torch.device(d) for d in devs)
        object.__setattr__(self, "devices", devs)
        if self.mesh is None:
            object.__setattr__(self, "mesh",
                               _slice_mesh(devs, range(len(devs))))

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The slice's first device: where a group keeps what is not laid
        out over the slice (sampling, a batch, the logits)."""
        return self.devices[0]

    def device_ids(self) -> Tuple[int, ...]:
        return tuple(int(i) for i in self.mesh.device_ids.flat)

    def crosses(self, other: "MeshSlice") -> bool:
        """Whether a move from this slice to ``other`` changes devices: it
        does unless both hold the same devices under the same ids (two
        slices of virtual devices on one card share the card, not the
        ids). ``StateManager.migrate`` and the process plane's migrate
        both decide ``cross_mesh`` here."""
        return (self.devices, self.device_ids()) != \
            (other.devices, other.device_ids())


def make_local_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """A (data, model) mesh over the first ``data * model`` of ``devices``
    (default: the CUDA devices); raises when there are fewer."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if data * model > n:
        raise ValueError(
            f"make_local_mesh(data={data}, model={model}) needs "
            f"{data * model} devices but only {n} are available; pass an "
            f"explicit device list (a device may repeat: virtual devices)")
    grid = [devices[i * model:(i + 1) * model] for i in range(data)]
    return Mesh(grid, ("data", "model"))


def _slice_cards(sl: MeshSlice) -> List[int]:
    """The slice's distinct CUDA cards, in the order they first appear."""
    cards: List[int] = []
    for d in sl.devices:
        if d.type == "cuda":
            idx = 0 if d.index is None else d.index
            if idx not in cards:
                cards.append(idx)
    return cards


def env_for_slice(sl: MeshSlice) -> Dict[str, str]:
    """The environment that makes a spawned group process see exactly its
    slice's cards: ``CUDA_VISIBLE_DEVICES`` set to them (each card once,
    in the slice's order), which the child then sees as ``cuda:0`` and
    on. A CPU slice (the tests) hides every card. Applied in the child
    before torch initialises CUDA."""
    return {"CUDA_VISIBLE_DEVICES": ",".join(str(i)
                                             for i in _slice_cards(sl))}


def devices_for_slice(sl: MeshSlice) -> List[str]:
    """The slice's devices as a group process sees them under
    :func:`env_for_slice`'s mask, one string per device of the slice (a
    child's config carries plain strings: unpickling a ``torch.device``
    would import torch before the environment is applied). A card becomes
    ``cuda:<its position among the slice's cards>``, so a virtual device
    repeats; any other device keeps its type (``cpu``)."""
    cards = _slice_cards(sl)
    return [f"cuda:{cards.index(0 if d.index is None else d.index)}"
            if d.type == "cuda" else d.type for d in sl.devices]


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
# tensor-core rate (no sparsity), HBM3 bandwidth and capacity, and NVLink 4's
# 900 GB/s a GPU, the production meshes' collective term's divisor (one card
# has no collectives: its term is 0). The NVLink rate is the datasheet's and
# a best case: only the eight GPUs of a node share it, and the links between
# nodes of a 256- or 512-GPU mesh are slower. No TPU figure is used.
HW = {
    "name": "NVIDIA H100 80GB HBM3 (SXM), 700 W",
    "peak_flops_bf16": 989e12,     # FLOP/s
    "hbm_bw": 3.35e12,             # bytes/s
    "hbm_bytes": 80e9,             # bytes
    "nvlink_bw": 900e9,            # bytes/s a GPU
}


def bound(nbytes: float, flops: float):
    """The least ms the card can take for work that moves ``nbytes`` and
    does ``flops`` bf16 operations, and which of the two bounds it:
    ``(ms, "bytes" | "operations")``."""
    t_bytes = nbytes / HW["hbm_bw"] * 1e3
    t_ops = flops / HW["peak_flops_bf16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The reference's production meshes (``repro/launch/mesh.py:42-45``)
    as H100s: (16, 16) over (``data``, ``model``), or (2, 16, 16) over
    (``pod``, ``data``, ``model``) with ``multi_pod``. Its devices are
    ``meta`` (the dry run counts there; nothing runs on 256 cards), or
    ``devices``, a list of as many (a device may repeat: virtual
    devices)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    devs = [torch.device("meta")] * n if devices is None else list(devices)
    if len(devs) != n:
        raise ValueError(f"a production mesh of {n} devices, given "
                         f"{len(devs)}")
    return Mesh(np.asarray(devs, dtype=object).reshape(shape), axes)


class DevicePlane:
    """Carves the devices into disjoint mesh slices and leases them to
    node groups.

    :meth:`carve` partitions the device list into contiguous slices
    (``slice_size`` devices each when given, else ``len(devices) //
    n_groups``, else one); :meth:`slice_for_group` leases the lowest-index
    free slice to a group and, when every slice is held, the least-loaded
    one (ties to the lowest index): on one default device every group
    shares the lone slice. :meth:`release` returns a retired group's
    lease. Idempotent per group id, clock-free and thread-safe."""

    def __init__(self, devices: Optional[Sequence] = None,
                 slice_size: Optional[int] = None):
        self._devices = None if devices is None \
            else [torch.device(d) for d in devices]
        if slice_size is not None and slice_size < 1:
            raise ValueError(f"slice_size {slice_size}")
        self.slice_size = slice_size
        self._slices: Optional[List[MeshSlice]] = None
        self._owner: Dict[int, int] = {}      # group id -> slice index
        self._holders: Dict[int, int] = {}    # slice index -> lease count
        self._lock = threading.Lock()

    def devices(self) -> List[torch.device]:
        if self._devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DevicePlane: no CUDA device; pass devices=[torch."
                    "device('cpu')] to run on the CPU")
            self._devices = [torch.device("cuda", i)
                             for i in range(torch.cuda.device_count())]
        return list(self._devices)

    def carve(self, n_groups: Optional[int] = None) -> List[MeshSlice]:
        """Partition the device list into disjoint slices. Callable before
        any lease; :meth:`slices` carves lazily with the defaults."""
        with self._lock:
            if self._owner:
                raise RuntimeError("cannot re-carve: slices are leased")
            return list(self._carve_locked(n_groups))

    def _carve_locked(self, n_groups: Optional[int] = None
                      ) -> List[MeshSlice]:
        devs = self.devices()
        if self.slice_size is not None:
            if self.slice_size > len(devs):
                # as make_local_mesh: a slice never quietly shrinks
                raise ValueError(
                    f"a slice of {self.slice_size} devices, but the plane "
                    f"has {len(devs)}; list the devices (a device may "
                    f"repeat: virtual devices)")
            size = self.slice_size
        elif n_groups:
            size = max(1, len(devs) // n_groups)
        else:
            size = 1
        self._slices = [
            MeshSlice(i, tuple(devs[i * size:(i + 1) * size]),
                      _slice_mesh(devs[i * size:(i + 1) * size],
                                  range(i * size, (i + 1) * size)))
            for i in range(len(devs) // size)]
        return self._slices

    def slices(self) -> List[MeshSlice]:
        with self._lock:
            if self._slices is None:
                self._carve_locked()
            return list(self._slices)

    def slice_for_group(self, group_id: int) -> MeshSlice:
        """The slice leased to ``group_id`` (leasing one if needed)."""
        return self.acquire(group_id)

    def acquire(self, group_id: int) -> MeshSlice:
        with self._lock:
            if self._slices is None:
                self._carve_locked()
            idx = self._owner.get(group_id)
            if idx is None:
                # the lowest free slice, else share the least-loaded one
                idx = min(self._slices, key=lambda s: (
                    self._holders.get(s.index, 0), s.index)).index
                self._owner[group_id] = idx
                self._holders[idx] = self._holders.get(idx, 0) + 1
            return self._slices[idx]

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
        layer's mesh-domain map: moves across domains pay the reshard)."""
        with self._lock:
            return dict(self._owner)
