"""Model State Manager: per-node-group authority over tensor residency
(paper §4.5), three tiers:

    DEVICE  — tensors on the node group's device (its slice's device)
    HOST    — CPU tensors, pinned when the device is CUDA (async DMA)
    DISK    — ``.npy`` spill files under ``disk_dir`` (bf16 as uint16)

Tensors are indexed by canonical logical key
(:func:`repro_torch.models.common.canonical_flat`), which deduplicates
replicas of one key. Offload and prefetch are timed and fed into
per-direction bandwidth EWMAs; HRRS reads its C_setup estimates from
``load_time_estimate`` / ``offload_time_estimate``. A CUDA copy returns
before its bytes have moved, so both transfers synchronize the device
before they read the clock: otherwise the times would be the enqueue, not
the copy; ``bytes_moved`` counts what each direction moved. With a
``device_capacity`` or ``host_capacity``, the least recently touched
entries are evicted DEVICE -> HOST -> DISK (§4.5.1).

Updates are in place (:meth:`write`, and ``optimizer.update_`` on the
gathered tensors): the reference re-registers a new tree after every
step, which here would allocate the pinned host buffers of a train
deployment (its parameters and f32 AdamW moments) again at its next
offload. An entry that goes to DISK gives up its pinned buffer: freeing
host memory is what the tier is for.

A group whose slice has several devices keeps a DEVICE entry as a
``Sharded`` value (``models/sharding.py``: one local tensor per device)
and records its layout (``Entry.sharding``): an offload moves each local
tensor into its own pinned buffer, a prefetch brings each back to its own
device in that layout, and a DISK spill holds the global tensor, laid out
again on its way back.

Migration (:meth:`migrate`) hands a job's entries to another group's
manager. Between groups that lease the same slice (every group on one
H100's single slice) a DEVICE entry changes owner without a copy
(``cross_mesh`` False); across slices it is resharded onto the
destination's mesh in its recorded spec (replicated where the spec does
not fit there), each local copied to its device: between virtual devices
of one card the copy is the hand-over itself. Between processes (the process plane)
:meth:`export_state` stages a job's entries to the host, each gathered
whole with its spec and its mesh's shape, and :meth:`import_state` adopts
them in the other process, laid out on its slice as :meth:`migrate` lays
them out. A checkpoint is materialised from the managed state, whichever
tier holds it (:meth:`materialize_checkpoint`), and
:meth:`host_optimizer_step` is the CPU AdamW of ZeRO-offload (§4.5.4),
over one device's entries or a slice's.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import os
import tempfile
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import common
from repro_torch.models import sharding as shd
from repro_torch.train import checkpoint as ckpt


class Tier(enum.IntEnum):
    DEVICE = 0
    HOST = 1
    DISK = 2


@dataclasses.dataclass
class Entry:
    key: str                         # canonical logical key (job-scoped)
    tier: Tier
    nbytes: int                      # the global tensor's bytes
    ref: Any                         # a tensor or ``Sharded`` on the device
    #                                  (DEVICE), the CPU (HOST); None (DISK)
    refcount: int = 1                # dedup count across logical replicas
    host: Any = None                 # pinned buffer(s) kept for reuse
    path: Optional[str] = None       # DISK spill file
    is_bf16: bool = False            # the spill file holds bf16 as uint16
    last_touch: int = 0              # LRU eviction order
    version: int = 0                 # host optimizer steps applied
    sharding: Any = None             # the layout over a slice of several
    #                                  devices (a ``NamedSharding``), else None


def _global_cpu(t) -> torch.Tensor:
    """A leaf as one CPU tensor: a ``Sharded`` one gathered."""
    return shd.gather(t, "cpu") if isinstance(t, shd.Sharded) else t


def _spill(path: str, t: torch.Tensor) -> bool:
    """Write ``t`` to an ``.npy`` file; returns whether it was bf16."""
    arr, dtype = ckpt.to_numpy(_global_cpu(t))
    np.save(path, arr)
    return dtype == "bfloat16"


def _unlink(paths: Sequence[str]):
    for path in paths:
        if os.path.exists(path):
            os.unlink(path)


def _unspill(e: Entry) -> torch.Tensor:
    arr = np.load(e.path)
    return ckpt.from_numpy(arr, "bfloat16" if e.is_bf16 else str(arr.dtype))


class StateManager:
    """One instance per node group. Owns every byte of managed model state."""

    def __init__(self, node_id: str = "node0",
                 device_capacity: float = float("inf"),
                 host_capacity: float = float("inf"),
                 disk_dir: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic,
                 mesh_slice=None):
        self.node_id = node_id
        self.device_capacity = device_capacity
        self.host_capacity = host_capacity
        self.disk_dir = disk_dir or os.path.join(tempfile.gettempdir(),
                                                 f"plexrl_{node_id}")
        self.clock = clock
        # the node group's MeshSlice: DEVICE-tier tensors live on its device
        self.mesh_slice = mesh_slice
        self.entries: Dict[str, Entry] = {}
        self._bw_estimate: Dict[str, float] = {}   # bytes/s per direction
        self.bytes_moved: Dict[str, int] = {"offload": 0, "load": 0,
                                            "migrate": 0}
        self.last_migrate: Optional[Dict[str, object]] = None
        # LRU order of the entries: a counter, not the injected clock, so
        # touching an entry costs no clock reading
        self._touch = itertools.count(1).__next__

    @property
    def device(self) -> torch.device:
        """The slice's first device (the CPU without a slice)."""
        return self.mesh_slice.device if self.mesh_slice is not None \
            else torch.device("cpu")

    @property
    def multi(self) -> bool:
        """Whether the slice has several devices (entries are
        ``Sharded``)."""
        return self.mesh_slice is not None and self.mesh_slice.n_devices > 1

    def _sync(self):
        devs = self.mesh_slice.devices if self.mesh_slice is not None \
            else (self.device,)
        for d in dict.fromkeys(devs):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _record(self, direction: str, nbytes: int, dt: float):
        self.bytes_moved[direction] += nbytes
        if dt > 0 and nbytes > 0:
            bw = nbytes / dt
            old = self._bw_estimate.get(direction)
            self._bw_estimate[direction] = bw if old is None else 0.7 * old + 0.3 * bw

    def _estimate(self, direction: str, nbytes: int, default_bw: float) -> float:
        bw = self._bw_estimate.get(direction, default_bw)
        return nbytes / max(bw, 1.0)

    def _tier_bytes(self, tier: Tier) -> int:
        return sum(e.nbytes for e in self.entries.values() if e.tier == tier)

    def usage(self) -> Dict[str, int]:
        return {t.name: self._tier_bytes(t) for t in Tier}

    @staticmethod
    def _pinned(buf, t):
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        return buf

    @staticmethod
    def _to_host(e: Entry):
        """Point a device entry at a host copy, in its pinned buffer (made at
        the first offload, reused after; one per local tensor of a
        ``Sharded`` entry). The copy is asynchronous: sync before the host
        reads it."""
        t = e.ref
        if isinstance(t, shd.Sharded):
            if t.device.type != "cpu":
                old = e.host if isinstance(e.host, list) \
                    else [None] * len(t.locals)
                e.host = [StateManager._pinned(b, loc)
                          for b, loc in zip(old, t.locals)]
                e.ref = shd.Sharded(e.host, t.sharding)
        elif t.device.type != "cpu":
            e.host = StateManager._pinned(e.host, t)
            e.ref = e.host

    def _on_device(self, e: Entry):
        """A HOST (or unspilled) entry's value back on the slice: each
        local to its own device in the recorded layout, or the global
        tensor laid out by it, or a plain tensor to the device."""
        t = e.ref
        if isinstance(t, shd.Sharded):
            return shd.Sharded([loc.to(d, non_blocking=True) for loc, d in
                                zip(t.locals, e.sharding.devices)],
                               e.sharding)
        if e.sharding is not None:
            return shd.shard(t, e.sharding)
        return t.to(self.device, non_blocking=True)

    def _layout_here(self, sharding, shape):
        """The layout an entry takes on this manager's slice: its spec on
        this slice's mesh where it fits, else replicated; None over one
        device."""
        if not self.multi:
            return None
        spec = sharding.spec if sharding is not None else shd.P()
        sh = shd.NamedSharding(self.mesh_slice.mesh, spec)
        return sh if sh.fits(shape) else shd.NamedSharding(
            self.mesh_slice.mesh, shd.P())

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
                    nbytes=leaf.numel() * leaf.element_size(), ref=leaf,
                    last_touch=self._touch(),
                    sharding=getattr(leaf, "sharding", None))
            keys.append(key)
        self._evict_if_needed()
        return keys

    def write(self, job_id: str, tree, prefix: str = "params") -> None:
        """Copy ``tree``'s values into the job's registered tensors, in
        place, wherever they are (device or host), resharded into a
        ``Sharded`` entry's layout. Each key must be registered, not on
        DISK and of the same shape and dtype."""
        for sub, leaf in common.canonical_flat(tree).items():
            e = self.entries[f"{job_id}/{prefix}/{sub}"]
            if e.tier == Tier.DISK or e.ref.shape != leaf.shape \
                    or e.ref.dtype != leaf.dtype:
                raise ValueError(
                    f"{e.key}: cannot write {tuple(leaf.shape)} {leaf.dtype} "
                    f"into {e.tier.name} {tuple(e.ref.shape)} {e.ref.dtype}")
            if isinstance(leaf, shd.Sharded) and \
                    not isinstance(e.ref, shd.Sharded):
                leaf = shd.gather(leaf, e.ref.device)
            e.ref.copy_(leaf)

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
                if e.path and os.path.exists(e.path):
                    os.unlink(e.path)
                del self.entries[k]

    # ------------------------------------------------------ tier movement
    def offload(self, keys: Sequence[str], to: Tier = Tier.HOST) -> float:
        """Move entries down to ``to``: DEVICE entries to HOST into pinned
        buffers reused across switches; any entry to DISK as a spill file
        (its pinned buffer released). Returns elapsed seconds, read off the
        injected clock after the device has finished the copies."""
        self._sync()
        t0 = self.clock()
        moved = 0
        for k in keys:
            e = self.entries.get(k)
            # a key may vanish mid-iteration when a deployment detaches
            if e is None or e.tier >= to:
                continue
            if to == Tier.HOST:
                self._to_host(e)
            else:
                os.makedirs(self.disk_dir, exist_ok=True)
                path = os.path.join(self.disk_dir,
                                    k.replace("/", "__") + ".npy")
                e.is_bf16 = _spill(path, e.ref)
                e.path, e.ref, e.host = path, None, None
            e.tier = to
            e.last_touch = self._touch()
            moved += e.nbytes
        self._sync()
        dt = self.clock() - t0
        self._record("offload", moved, dt)
        return dt

    def prefetch(self, keys: Sequence[str]) -> float:
        """Move HOST and DISK entries up to DEVICE (scheduler-directed
        prefetch); a DISK entry's spill file is read and removed. Timed
        like :meth:`offload`."""
        self._sync()
        t0 = self.clock()
        moved = 0
        for k in keys:
            e = self.entries.get(k)
            if e is None or e.tier == Tier.DEVICE:
                continue
            if e.tier == Tier.DISK:
                e.ref = _unspill(e)
                os.unlink(e.path)
                e.path = None
            e.ref = self._on_device(e)
            e.tier = Tier.DEVICE
            e.last_touch = self._touch()
            moved += e.nbytes
        self._sync()
        dt = self.clock() - t0
        self._record("load", moved, dt)
        self._evict_if_needed()
        return dt

    def _evict_if_needed(self):
        """Capacity-aware LRU eviction DEVICE -> HOST -> DISK."""
        while self._tier_bytes(Tier.DEVICE) > self.device_capacity:
            victim = min((e for e in self.entries.values()
                          if e.tier == Tier.DEVICE),
                         key=lambda e: e.last_touch)
            self.offload([victim.key], Tier.HOST)
        while self._tier_bytes(Tier.HOST) > self.host_capacity:
            victim = min((e for e in self.entries.values()
                          if e.tier == Tier.HOST),
                         key=lambda e: e.last_touch)
            self.offload([victim.key], Tier.DISK)

    def migrate(self, job_id: str, dst: "StateManager") -> int:
        """Cross-group migration (§4.5.3): hand the job's entries to
        ``dst`` and drop them here. Returns the bytes moved.

        Within one slice (``cross_mesh`` False: the same devices and ids)
        a DEVICE entry changes owner as it is: a round trip through the
        host would buy nothing. Across slices it is resharded onto
        ``dst``'s mesh (:meth:`_reshard`) and the clock is read after a
        sync. A HOST entry moves with its pinned buffers, its layout
        re-targeted to ``dst``'s mesh. A DISK entry is read from its spill
        file and lands on HOST, as the reference has it. Transactional:
        nothing is dropped here until every entry has landed on ``dst``; a
        failure in the middle rolls ``dst`` back and leaves this manager
        as it was."""
        src_sl, dst_sl = self.mesh_slice, dst.mesh_slice
        cross_mesh = dst.device != self.device if src_sl is None or \
            dst_sl is None else src_sl.crosses(dst_sl)
        self._sync()
        t0 = self.clock()
        keys = list(self.keys_for(job_id))
        staged: List[str] = []
        moved = 0
        try:
            for k in keys:
                e = self.entries[k]
                if e.tier == Tier.DISK:
                    # read the spill file: ``unregister`` below deletes it
                    t = _unspill(e)
                    dst.entries[k] = dataclasses.replace(
                        e, tier=Tier.HOST, ref=t, refcount=1, path=None,
                        is_bf16=False, host=None,
                        sharding=dst._layout_here(e.sharding, t.shape))
                elif not cross_mesh:
                    dst.entries[k] = dataclasses.replace(e, refcount=1)
                else:
                    dst.entries[k] = dst._reshard(e)
                staged.append(k)
                moved += e.nbytes
            dst._sync()
        except Exception:
            for k in staged:     # rollback: the source still owns the state
                dst.entries.pop(k, None)
            raise
        for k in keys:
            self.unregister([k])
        dst._evict_if_needed()
        dt = self.clock() - t0
        self._record("migrate", moved, dt)
        self.last_migrate = {"bytes": moved, "seconds": dt,
                             "cross_mesh": cross_mesh, "keys": len(keys)}
        return moved

    def _reshard(self, e: Entry) -> Entry:
        """Another slice's DEVICE or HOST entry in this slice's layout: a
        DEVICE one on this slice's devices (each local copied to its
        counterpart where the layouts match, else gathered and laid out
        again), a HOST one kept on the host in a layout this slice's
        prefetch restores."""
        ref, sh = e.ref, self._layout_here(e.sharding, e.ref.shape)
        same = isinstance(ref, shd.Sharded) and sh is not None and \
            tuple(ref.sharding.spec) == tuple(sh.spec) and \
            ref.sharding.mesh.shape == sh.mesh.shape
        if e.tier == Tier.HOST:
            if same:
                ref = shd.Sharded(ref.locals, sh)
            elif isinstance(ref, shd.Sharded):
                ref = _global_cpu(ref)
            return dataclasses.replace(
                e, ref=ref, refcount=1, sharding=sh,
                host=e.host if same or not isinstance(e.ref, shd.Sharded)
                else None)
        if sh is None:
            ref = shd.gather(ref, self.device) \
                if isinstance(ref, shd.Sharded) \
                else ref.to(self.device, non_blocking=True)
        elif same:
            ref = shd.Sharded([t.to(d, non_blocking=True) for t, d in
                               zip(ref.locals, sh.devices)], sh)
        else:
            ref = shd.shard(shd.gather(ref) if isinstance(ref, shd.Sharded)
                            else ref, sh)
        return dataclasses.replace(e, ref=ref, refcount=1, sharding=sh)

    # ------------------------------------ cross-PROCESS migration halves
    def export_state(self, job_id: str, max_inline_bytes: int = 64 << 20
                     ) -> Dict[str, Any]:
        """Stage a job's managed state for another process (the process
        plane's migrate-export): every entry as a host numpy array (a
        ``Sharded`` one gathered), bf16 as its 16-bit pattern
        (``is_bf16``), with the spec of its layout over a slice of several
        devices (``spec``, None over one device), as the reference records
        it. An entry above
        ``max_inline_bytes`` spills to ``export__{txn}__<key>.npy`` under
        ``disk_dir`` (``np.save``, the reference's format) and travels by
        path. Non-destructive: the source keeps its entries until the
        importer has committed and the caller drops them.

        Spill files belong to the transfer: the importer deletes them on
        commit and on rollback (:meth:`import_state`), the caller when the
        importer died first (``StateManagerProxy.migrate``), and a respawn
        sweeps what a crash left."""
        keys = list(self.keys_for(job_id))
        txn = uuid.uuid4().hex[:12]
        entries = []
        spills: List[str] = []
        total = 0
        self._sync()
        t0 = self.clock()
        for k in keys:
            e = self.entries[k]
            if e.tier == Tier.DISK:
                arr, is_bf16 = np.load(e.path), e.is_bf16
            else:
                arr, dtype = ckpt.to_numpy(_global_cpu(e.ref))
                is_bf16 = dtype == "bfloat16"
            sh = e.sharding
            ent = {"key": k, "nbytes": e.nbytes, "version": e.version,
                   "tier": int(e.tier), "is_bf16": is_bf16,
                   "spec": None if sh is None else tuple(sh.spec),
                   "path": None, "data": None}
            if arr.nbytes > max_inline_bytes:
                os.makedirs(self.disk_dir, exist_ok=True)
                path = os.path.join(
                    self.disk_dir,
                    f"export__{txn}__" + k.replace("/", "__") + ".npy")
                np.save(path, arr)
                ent["path"] = path
                spills.append(path)
            else:
                ent["data"] = arr
            entries.append(ent)
            total += e.nbytes
        self._record("migrate", total, self.clock() - t0)
        return {"job_id": job_id, "entries": entries, "bytes": total,
                "txn": txn, "spills": spills}

    def import_state(self, payload: Dict[str, Any]) -> int:
        """Adopt an :meth:`export_state` payload: entries exported from
        DEVICE land on this manager's slice, HOST and DISK ones on HOST.
        Over a slice of several devices each entry takes
        :meth:`_layout_here` of its recorded spec, as :meth:`migrate`
        re-lays an entry out: the spec itself on this slice's mesh where it
        fits (so always between meshes of one shape), else replicated. A
        DEVICE entry is laid out on the slice's devices, a HOST one kept
        whole in the layout this slice's :meth:`prefetch` restores.
        Every entry is copied out of the payload (its tensors may be views
        over a shared segment that is recycled once this returns). A
        failure removes every staged entry before it re-raises, so the
        exporter stays the sole owner; the transfer's spill files are
        deleted on commit and on rollback. Returns the bytes adopted; the
        caller synchronises the device before it acks the transfer."""
        t0 = self.clock()
        staged: List[str] = []
        spills = [p for p in payload.get("spills", ())
                  if p and os.path.basename(p).startswith("export__")]
        moved = 0
        try:
            for ent in payload["entries"]:
                data = np.load(ent["path"]) if ent["path"] is not None \
                    else ent["data"]
                t = torch.as_tensor(data)
                if ent["is_bf16"]:
                    t = t.view(torch.bfloat16)
                spec = ent.get("spec")
                sh = self._layout_here(
                    shd.NamedSharding(self.mesh_slice.mesh, shd.P(*spec))
                    if spec is not None and self.multi else None, t.shape)
                if Tier(ent["tier"]) != Tier.DEVICE:
                    tier, ref = Tier.HOST, t.to("cpu", copy=True)
                elif sh is not None:
                    tier, ref = Tier.DEVICE, shd.shard(t, sh)
                else:
                    tier, ref = Tier.DEVICE, t.to(self.device, copy=True)
                self.entries[ent["key"]] = Entry(
                    key=ent["key"], tier=tier, nbytes=ent["nbytes"],
                    ref=ref, version=ent["version"],
                    last_touch=self._touch(), sharding=sh)
                staged.append(ent["key"])
                moved += ent["nbytes"]
        except Exception:
            for k in staged:     # rollback: the exporter still owns the state
                self.entries.pop(k, None)
            _unlink(spills)      # the transfer is over: nobody reads them
            raise
        _unlink(spills)
        self._evict_if_needed()
        dt = self.clock() - t0
        self._record("load", moved, dt)
        self.last_migrate = {"bytes": moved, "seconds": dt,
                             "cross_mesh": True,
                             "keys": len(payload["entries"])}
        return moved

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
        CPU; DISK entries are read from their spill files, lazily, and
        stay on DISK)."""
        pre = f"{job_id}/{prefix}/"
        flat = {k[len(pre):]: _unspill(e) if e.tier == Tier.DISK else e.ref
                for k, e in self.entries.items() if k.startswith(pre)}
        return common.canonical_unflatten(template, flat)

    def materialize_checkpoint(self, job_id: str, template, path: str,
                               step: int = 0, prefix: str = "params") -> str:
        """Checkpoint = materialisation from managed state (§4.5.3): works
        whichever tier holds the state; no user-triggered export path."""
        tree = common.tree_map(_global_cpu,
                               self.gather(job_id, template, prefix))
        return ckpt.save(path, tree, step=step,
                         extra_meta={"job_id": job_id, "node": self.node_id})

    def sync_weights(self, job_id: str, template, target_shardings=None,
                     prefix: str = "params"):
        """Weight synchronisation (``repro/core/state_manager.py:290-
        300``): the job's parameters laid out in ``target_shardings`` (a
        tree of ``NamedSharding``, the target deployment's), each leaf a
        copy made from the blocks in hand, or, without targets, the tree
        as it is (the caller copies it where it lands)."""
        tree = self.gather(job_id, template, prefix)
        if target_shardings is None:
            return tree
        return shd.device_put(tree, target_shardings)

    # ------------------------------------------- §4.5.4 host optimizer
    def host_optimizer_step(self, job_id: str, grads_tree, template,
                            lr: float = 3e-5, b1: float = 0.9,
                            b2: float = 0.95, eps: float = 1e-8,
                            prefix: str = "params") -> int:
        """CPU AdamW over host-resident canonical state (ZeRO-offload): no
        clip, warmup or weight decay; bias correction by the new step.
        Returns the new step count.

        The moments are created on HOST at first use, f32 whole-leaf
        tensors, under the device optimizer's ``{job}/opt/mu|nu/...`` keys;
        moments that already live on DEVICE are updated there, in place,
        as the reference updates them where they are (a slice's, block by
        block on each device). A DEVICE parameter is pulled to HOST (into
        its pinned buffers where it has them) and stays there until the
        next prefetch. Over a slice of several devices a gradient may be
        ``Sharded`` (thread mode) or whole (from the process plane's pipe);
        the step runs on the gathered leaf and writes the new value into
        every local block of the parameter's host copy, replicas the same
        bits, so the next prefetch restores the slice's layout. Every
        tensor is written in place: nothing is re-registered."""
        pre = f"{job_id}/{prefix}/"
        step_key = f"{job_id}/opt/step"
        if step_key not in self.entries:
            self.entries[step_key] = Entry(
                step_key, Tier.HOST, 8, ref=torch.zeros((), dtype=torch.int64),
                last_touch=self._touch())
        steps = shd.local_tensors(self.entries[step_key].ref)
        step = int(steps[0]) + 1
        for t in steps:
            t.fill_(step)
        c1 = 1.0 - b1 ** step
        c2 = 1.0 - b2 ** step
        gflat = common.canonical_flat(grads_tree)
        for sub in gflat:
            e = self.entries[pre + sub]
            if e.tier == Tier.DEVICE:
                self._to_host(e)
                e.tier = Tier.HOST
                e.last_touch = self._touch()
        self._sync()
        for sub, g in gflat.items():
            e = self.entries[pre + sub]
            p = _global_cpu(e.ref).float()
            g32 = _global_cpu(g).detach().to("cpu", torch.float32)
            for mom in ("mu", "nu"):
                mkey = f"{job_id}/opt/{mom}/{sub}"
                if mkey not in self.entries:
                    self.entries[mkey] = Entry(
                        mkey, Tier.HOST, g32.numel() * 4,
                        ref=torch.zeros_like(g32), last_touch=self._touch())
            mu = self.entries[f"{job_id}/opt/mu/{sub}"].ref
            nu = self.entries[f"{job_id}/opt/nu/{sub}"].ref
            upd = []
            for pos, (m, v) in enumerate(zip(shd.local_tensors(mu),
                                             shd.local_tensors(nu))):
                gm = (g32[mu.sharding.slices(pos, g32.shape)]
                      if isinstance(mu, shd.Sharded) else g32).to(m.device)
                m.copy_(b1 * m + (1 - b1) * gm)
                v.copy_(b2 * v + (1 - b2) * torch.square(gm))
                upd.append((m / c1) / (torch.sqrt(v / c2) + eps))
            upd = shd.gather(shd.Sharded(upd, mu.sharding), "cpu") \
                if isinstance(mu, shd.Sharded) else upd[0].cpu()
            # a Sharded host copy takes the global value into each block
            e.ref.copy_(p - lr * upd)
            e.version += 1
        return step
