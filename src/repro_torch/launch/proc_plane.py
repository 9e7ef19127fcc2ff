"""Process plane: each node group's WPGs in their own worker process.

The port of ``repro.launch.proc_plane``. Thread-mode dispatch workers share
one interpreter, so two groups' host work (a decode step's eager launches,
the controller's packing) serialises on the GIL even when both groups feed
the same card. In process mode each node group's WPGs live in a separate OS
process bound to the group's device slice, and the Router's dispatch
protocol crosses a pipe instead of a method call. A slice may hold several
devices: the child sees the slice's cards, builds the parent's
:class:`~repro_torch.launch.mesh.MeshSlice` (the same device ids) over
them, and its WPGs run tensor-parallel there as in thread mode.

Pieces
------
- :class:`GroupProcess`: the parent's handle on one group's worker
  process. Spawned, never forked (the parent holds a CUDA context and
  dispatch threads), with the slice's environment
  (:func:`repro_torch.launch.mesh.env_for_slice`: ``CUDA_VISIBLE_DEVICES``,
  applied in the child before torch loads), its devices as plain strings
  in its config (:func:`repro_torch.launch.mesh.devices_for_slice`) and
  the slice's device ids. A length-prefixed pickle protocol over a duplex
  pipe carries ``create_deployment`` / ``execute`` / ``migrate_export`` /
  ``migrate_import`` / ``sync_export`` / ``store_params`` / ``ping`` /
  ``shutdown`` and the StateManager queries. ``respawn()`` replaces a dead
  child in place and replays its deployments.
- :class:`WPGProxy`: what ``Router.wpgs[dep]`` holds in process mode. Each
  completed ``execute`` reply carries the child's ``(op, seconds)`` entry,
  which the proxy appends to a local :class:`~repro_torch.core.worker.
  ExecLog` mirror, so billing reads the usual ring and completed work stays
  billed if the child dies later.
- :class:`StateManagerProxy`: the StateManager surface the Router reads,
  and the cross-process :meth:`StateManagerProxy.migrate` made of the
  child-side ``StateManager.export_state`` / ``import_state``.

A parent thread blocked in ``recv`` releases the GIL, so dispatch threads
that proxy into different children overlap.

Tensors in requests and replies: CUDA tensors never cross. A child stages
every result to host tensors (a ``Sharded`` one gathered to one CPU
tensor), the large ones ride
:mod:`repro_torch.launch.shm_transport` segments (descriptors on the pipe),
the small ones the pickle. A reply acks its request's segments (a handler
that lands tensors on its device synchronises the device before it
replies); the parent acks a reply's segments with a ``shm_release`` frame.
Cross-child payloads (a weight sync, a migration) are relayed: the parent
forwards the source child's descriptors untouched and releases them to
the source after the destination's reply. A dead child's segments are
reaped by name prefix.

This module imports only the stdlib at module level: a spawned child
imports it before it applies its device environment. torch, the worker and
the StateManager load in the child after that.
"""
from __future__ import annotations

import glob
import importlib
import itertools
import logging
import multiprocessing
import os
import pickle
import struct
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.launch import shm_transport as shmt

logger = logging.getLogger(__name__)

_LEN = struct.Struct("!I")
_nonce = itertools.count(1)

# request kinds whose decoded tensors may stay VIEWS over shared segments:
# their handlers copy them out (onto the device, or into owned tensors)
# before replying, which lets the reply double as the release ack
_VIEW_KINDS = frozenset({"store_params", "migrate_import"})


class GroupProcessError(RuntimeError):
    """The group's worker process is dead or the channel broke mid-call."""


# ------------------------------------------------------------ wire format
def _send(conn, obj) -> None:
    """One frame = two pipe messages: a 4-byte big-endian length, then the
    pickled body. The receiver rejects a truncated frame instead of
    unpickling garbage; the protocol is serial per channel, so the two
    messages never interleave with another frame."""
    buf = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    conn.send_bytes(_LEN.pack(len(buf)))
    conn.send_bytes(buf)


def _recv(conn):
    hdr = conn.recv_bytes()
    if len(hdr) != _LEN.size:
        raise EOFError("truncated frame (bad length prefix)")
    (n,) = _LEN.unpack(hdr)
    body = conn.recv_bytes()
    if len(body) != n:
        raise EOFError(
            f"frame length mismatch: prefix says {n}, got {len(body)}")
    return pickle.loads(body)


def _unlink_spills(payload) -> List[str]:
    """Delete a migrate-export payload's transfer spill files (only
    ``export__`` ones, never disk-tier state). Idempotent."""
    removed = []
    for ent in payload.get("entries", ()):
        path = ent.get("path")
        if path and os.path.basename(path).startswith("export__"):
            try:
                os.unlink(path)
                removed.append(path)
            except OSError:
                pass
    return removed


def _resolve_factory(ref: Optional[str]):
    """Factories cross the spawn boundary by NAME ("module:callable"):
    None is the real WorkerProcessGroup (imports torch, in the child, after
    the device environment is applied)."""
    if ref is None:
        from repro_torch.core.worker import WorkerProcessGroup
        return WorkerProcessGroup
    mod, _, name = ref.partition(":")
    if not name:
        raise ValueError(f"factory ref {ref!r} is not 'module:callable'")
    return getattr(importlib.import_module(mod), name)


def _to_host(obj):
    """A result tree with every device tensor copied to the host (the
    reply's pickle and the shm writer take host memory only), a
    ``Sharded`` one (a slice's gradients) gathered to one CPU tensor. Does
    nothing in a child that never loaded torch."""
    torch = sys.modules.get("torch")
    if torch is None:
        return obj
    shd = sys.modules.get("repro_torch.models.sharding")

    def conv(x):
        if shd is not None and isinstance(x, shd.Sharded):
            return shd.gather(x, "cpu").detach()
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            return x.detach().cpu()
        return x

    return shmt._walk(obj, conv)


# ------------------------------------------------------------- child side
class _LiteSM:
    """A light StateManager stand-in for stub factories
    (``needs_state_manager = False``): keeps the child torch-free."""

    mesh_slice = None

    def __init__(self):
        self.entries: Dict[str, Any] = {}
        self.bytes_moved = {"offload": 0, "load": 0, "migrate": 0}

    def job_bytes(self, job_id: str) -> int:
        return 0

    def load_time_estimate(self, nbytes: int) -> float:
        return 0.0

    def offload_time_estimate(self, nbytes: int) -> float:
        return 0.0

    def keys_for(self, job_id: str, prefix=None) -> list:
        return []

    def unregister(self, keys) -> None:
        pass


class _ChildState:
    """What a group's worker process owns: its StateManager over the
    child's devices, the group's slice (made on first need), and one WPG
    per registered deployment."""

    def __init__(self, cfg: Dict[str, Any]):
        self.cfg = cfg
        self.wpgs: Dict[str, Any] = {}
        self._sm = None
        self._lite: Optional[_LiteSM] = None

    @property
    def sm(self):
        return self._sm if self._sm is not None else self._lite

    def _state_manager(self, needs_real: bool):
        if not needs_real:
            if self._lite is None:
                self._lite = _LiteSM()
            return self._lite
        if self._sm is None:
            import torch

            from repro_torch.core.state_manager import StateManager
            from repro_torch.launch.mesh import MeshSlice, _slice_mesh

            devs = [torch.device(d) for d in self.cfg["devices"]]
            ids = self.cfg["device_ids"]
            cards = [d.index or 0 for d in devs if d.type == "cuda"]
            seen = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            if cards and max(cards) >= seen:
                raise RuntimeError(
                    f"group {self.cfg['group_id']}: the slice is "
                    f"{[str(d) for d in devs]} but this worker process sees "
                    f"{seen or 'no'} CUDA device(s) (CUDA_VISIBLE_DEVICES="
                    f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
            self._sm = StateManager(
                node_id=self.cfg["node_id"],
                mesh_slice=MeshSlice(self.cfg["slice_index"], tuple(devs),
                                     _slice_mesh(devs, ids)))
        return self._sm

    def _own_shardings(self, shardings):
        """A tree of the parent's ``NamedSharding``\\ s re-bound to this
        child's mesh: the same specs, over this child's view of the
        devices. They must name this group's slice (the same device ids)."""
        from repro_torch.models import common
        from repro_torch.models import sharding as shd

        mesh = self._state_manager(True).mesh_slice.mesh

        def one(sh):
            if sh.mesh.device_ids.tolist() != mesh.device_ids.tolist():
                raise ValueError(
                    f"target shardings over device ids "
                    f"{sh.mesh.device_ids.tolist()}, but group "
                    f"{self.cfg['group_id']}'s slice is "
                    f"{mesh.device_ids.tolist()}")
            return shd.NamedSharding(mesh, sh.spec)

        return common.tree_map(one, shardings)

    # ---------------------------------------------------------- handlers
    def handle(self, kind: str, payload) -> Tuple[Any, Any]:
        return getattr(self, f"_h_{kind}")(payload)

    def _h_create_deployment(self, p):
        factory = _resolve_factory(p["factory"])
        sm = self._state_manager(getattr(factory, "needs_state_manager", True))
        self.wpgs[p["spec"].deployment_id] = factory(p["spec"], sm)
        return None, None

    def _h_drop_deployment(self, p):
        self.wpgs.pop(p["dep"], None)
        return None, None

    def _h_execute(self, p):
        from repro_torch.core import api

        wpg = self.wpgs[p["dep"]]
        op = api.Op(p["op"])
        args = tuple(p["args"])
        if (op is api.Op.SYNC_WEIGHTS and args
                and isinstance(args[0], tuple) and len(args[0]) == 2
                and args[0][0] == "__dep__"):
            # a sync between deployments of this child: the marker names
            # the target WPG (cross-child syncs are relayed by WPGProxy)
            args = (self.wpgs[args[0][1]],) + args[1:]
        kwargs = dict(p["kwargs"])
        if kwargs.get("target_shardings") is not None:
            kwargs["target_shardings"] = self._own_shardings(
                kwargs["target_shardings"])
        qop = api.QueuedOperation(
            req_id=p["req_id"], deployment_id=p["dep"], job_id=p["job_id"],
            op=op, args=args, kwargs=kwargs)
        t0 = time.monotonic()
        result = wpg.execute(qop)
        return _to_host(result), (op.value, time.monotonic() - t0)

    def _h_resident(self, p):
        return self.wpgs[p["dep"]].resident(), None

    def _h_ensure_resident(self, p):
        return self.wpgs[p["dep"]].ensure_resident(), None

    def _h_offload(self, p):
        sm_mod = sys.modules.get("repro_torch.core.state_manager")
        tier = p["tier"] if sm_mod is None else sm_mod.Tier(p["tier"])
        return self.wpgs[p["dep"]].offload(tier), None

    def _h_sync_export(self, p):
        return self.wpgs[p["dep"]].host_params(), None

    def _h_store_params(self, p):
        """A synced tree into the deployment: written into the parameters
        it holds, else laid out in the op's ``target_shardings`` (re-bound
        to this child's devices) or the WPG's own shardings. The store
        copies out of the mapped views; the device is synced before the
        reply, which lets the writer recycle the segment."""
        wpg = self.wpgs[p["dep"]]
        if p.get("shardings") is None:
            wpg._store_params(p["tree"])
        else:
            wpg._store_params(p["tree"], self._own_shardings(p["shardings"]))
        if self._sm is not None:
            self._sm._sync()
        return None, None

    def _h_job_bytes(self, p):
        return (0 if self.sm is None else self.sm.job_bytes(p["job"])), None

    def _h_bytes_moved(self, p):
        sm = self.sm
        return (None if sm is None else dict(sm.bytes_moved)), None

    def _h_load_estimate(self, p):
        sm = self.sm
        return (0.0 if sm is None
                else sm.load_time_estimate(p["nbytes"])), None

    def _h_offload_estimate(self, p):
        sm = self.sm
        return (0.0 if sm is None
                else sm.offload_time_estimate(p["nbytes"])), None

    def _h_keys_for(self, p):
        sm = self.sm
        return ([] if sm is None
                else list(sm.keys_for(p["job"], p.get("prefix")))), None

    def _h_all_keys(self, p):
        return ([] if self.sm is None else list(self.sm.entries)), None

    def _h_unregister(self, p):
        if self.sm is not None:
            self.sm.unregister(p["keys"])
        return None, None

    def _h_migrate_export(self, p):
        sm = self._state_manager(True)
        return sm.export_state(p["job"],
                               max_inline_bytes=p["max_inline"]), None

    def _h_migrate_import(self, p):
        sm = self._state_manager(True)
        moved = sm.import_state(p["payload"])
        # the reply releases the source's segments: the copies onto the
        # device must have read them by then
        sm._sync()
        return moved, None

    def _h_drop_job_state(self, p):
        sm = self.sm
        if sm is not None:
            sm.unregister(sm.keys_for(p["job"]))
        return None, None

    def _h_probe(self, p):
        """Instrumentation: this process's pid, its kernel launch counts
        (None before the kernels' wrappers load; zeroed first on
        ``reset``), its CUDA caching allocator's bytes and peak (None
        before CUDA initialises here; the peak reset on ``reset``) and,
        given ``layouts`` (a job prefix), where each of the job's entries
        lies (:meth:`_layouts`; with ``digests``, a digest of each one's
        gathered bits too) and the seconds that took."""
        out = {"pid": os.getpid(), "launches": None,
               "cuda_allocated": None, "cuda_reserved": None,
               "cuda_peak": None}
        ops = sys.modules.get("repro_torch.kernels.ops")
        if ops is not None:
            if p and p.get("reset"):
                ops.reset_launches()
            out["launches"] = dict(ops.LAUNCHES)
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            out["cuda_allocated"] = torch.cuda.memory_allocated()
            out["cuda_reserved"] = torch.cuda.memory_reserved()
            out["cuda_peak"] = torch.cuda.max_memory_allocated()
            if p and p.get("reset"):
                torch.cuda.reset_peak_memory_stats()
        if p and p.get("layouts"):
            t0 = time.monotonic()
            out["layouts"] = self._layouts(p["layouts"],
                                           bool(p.get("digests")))
            out["layouts_seconds"] = time.monotonic() - t0
        return out, None

    def _layouts(self, prefix: str, digests: bool) -> Dict[str, Any]:
        """Each entry of a job: its tier, its global shape, its spec and its
        mesh's device ids over a slice of several devices (None over one),
        each local tensor's device, whether every replica of each block
        holds the same bits, and with ``digests`` an order-sensitive digest
        of its gathered bits, computed where the entry lives (equal across
        layouts, devices and processes for equal bits)."""
        import torch

        from repro_torch.models import sharding as shd

        def digest(t) -> int:
            v = t.detach().reshape(-1).view(
                {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}[t.element_size()])
            w = torch.arange(1, min(v.numel(), 1 << 24) + 1,
                             device=v.device, dtype=torch.int64)
            sums = [(c.to(torch.int64) * w[:c.numel()]).sum()
                    for c in v.split(1 << 24)]
            acc = 0
            for x in torch.stack(sums).tolist():    # one sync an entry
                acc = acc * 1_000_003 + x
            return acc

        def replicas_same(ref) -> bool:
            if not isinstance(ref, shd.Sharded):
                return True
            first = {}
            for pos, t in enumerate(ref.locals):
                b = ref.sharding.block(pos, ref.dim())
                if b in first and not torch.equal(t, first[b]):
                    return False
                first.setdefault(b, t)
            return True

        sm = self._state_manager(True)
        out = {}
        for k in sm.keys_for(prefix):
            e = sm.entries[k]
            sh = e.sharding
            out[k] = {
                "tier": int(e.tier),
                "shape": None if e.ref is None else list(e.ref.shape),
                "spec": None if sh is None else tuple(sh.spec),
                "ids": None if sh is None
                else sh.mesh.device_ids.reshape(-1).tolist(),
                "devices": None if e.ref is None
                else [str(t.device) for t in shd.local_tensors(e.ref)],
                "replicas_same": e.ref is None or replicas_same(e.ref)}
            if digests and e.ref is not None:
                out[k]["digest"] = digest(shd.gather(e.ref))
        return out


def _group_main(conn, cfg: Dict[str, Any]) -> None:
    """Worker-process entry point. Its FIRST statement applies the slice's
    environment: CUDA reads ``CUDA_VISIBLE_DEVICES`` when torch initialises
    it, so nothing that loads torch is imported before this line."""
    os.environ.update(cfg["env"])
    state = _ChildState(cfg)
    shm_cfg = cfg.get("shm") or {}
    transport = shmt.Transport(
        prefix=shm_cfg.get("prefix", f"pxl{os.getpid()}c"),
        enabled=bool(shm_cfg.get("enabled")),
        threshold=int(shm_cfg.get("threshold", shmt.DEFAULT_THRESHOLD)))
    try:
        _send(conn, ("ready", os.getpid()))
    except OSError:
        return
    try:
        while True:
            try:
                kind, payload = _recv(conn)
            except (EOFError, OSError):
                break                  # the parent went away: exit with it
            if kind == "shutdown":
                try:
                    _send(conn, ("ok", None, None))
                except OSError:
                    pass
                break
            if kind == "shm_release":
                # the parent consumed these segments of OUR pool
                transport.release(payload)
                continue
            if kind == "ping":
                try:
                    _send(conn, ("ok", payload, None))
                except OSError:
                    break
                continue
            reply_segs: List[str] = []
            try:
                if transport.enabled and shmt.has_refs(payload):
                    # view kinds copy out before replying; every other
                    # kind gets owning copies (results may be kept)
                    payload = transport.decode(
                        payload, copy=kind not in _VIEW_KINDS)
                result, extra = state.handle(kind, payload)
                payload = None          # drop the views before the ack
                result, reply_segs = transport.encode(result)
                reply = ("ok", result, extra)
            except BaseException as e:  # noqa: BLE001 - surface to parent
                payload = None
                reply = ("err", f"{type(e).__name__}: {e}",
                         traceback.format_exc())
            try:
                _send(conn, reply)
            except (OSError, pickle.PicklingError) as e:
                # an unpicklable result fails the one op, not the channel;
                # the parent never saw the descriptors: back to the pool
                transport.release(reply_segs)
                try:
                    _send(conn, ("err",
                                 f"reply serialization failed: {e}", None))
                except OSError:
                    break
    finally:
        # a graceful exit unlinks the child's pool; after a crash this
        # never runs and the parent reaps by prefix
        transport.close()


# ------------------------------------------------------------ parent side
class GroupProcess:
    """The parent's handle on one node group's worker process.

    The request/reply protocol is serial per process under an RLock: the
    executor's group locks already serialise dispatch, so the lock orders
    control calls (migration, teardown, heartbeat) against it. A blocked
    ``recv`` releases the GIL: there the groups overlap.

    ``start()`` returns once the OS process is launched; the ready
    handshake is awaited on the first call."""

    def __init__(self, group_id: int, env: Optional[Dict[str, str]] = None,
                 slice_index: int = 0, wpg_factory: Optional[str] = None,
                 node_id: Optional[str] = None, start: bool = True,
                 shm: Optional[bool] = None,
                 shm_threshold: Optional[int] = None,
                 devices: Optional[List[str]] = None,
                 device_ids: Optional[List[int]] = None):
        """``devices`` are the child's devices as strings, one per device of
        its slice (``mesh.devices_for_slice``): by default ``["cuda:0"]``
        (under ``env_for_slice``'s ``CUDA_VISIBLE_DEVICES`` mask, the
        slice's card), where a child that sees too few cards raises, or
        ``"cpu"``, which only an explicit request gets. With
        ``device_ids`` (the slice's ids in the parent's plane; default 0
        and on) they make the child's slice: its StateManager's
        ``MeshSlice``, equal in its ids to the parent's. ``shm=None`` turns
        the shared-memory transport on where the host supports it
        (``shm_transport.shm_available``), ``False`` keeps the pickle
        path; ``shm_threshold`` is the tensor size in bytes from which
        tensors ride shm."""
        self.group_id = group_id
        self.env = dict(env or {})
        self.slice_index = slice_index
        self.wpg_factory = wpg_factory
        self.devices = list(devices) if devices else ["cuda:0"]
        self.device = self.devices[0]
        self.device_ids = list(range(len(self.devices))) \
            if device_ids is None else [int(i) for i in device_ids]
        if len(self.device_ids) != len(self.devices):
            raise ValueError(f"{len(self.devices)} devices but device ids "
                             f"{self.device_ids}")
        self.node_id = node_id or f"group{group_id}-proc"
        self.shm_enabled = (shmt.shm_available() if shm is None
                            else bool(shm) and shmt.shm_available())
        self.shm_threshold = (shmt.DEFAULT_THRESHOLD if shm_threshold is None
                              else int(shm_threshold))
        self._transport: Optional[shmt.Transport] = None
        self._child_prefix = ""
        # child segment names seen on this channel: the reap fallback where
        # there is no scannable /dev/shm
        self._seen_child_segs: set = set()
        self._lock = threading.RLock()
        self._conn = None
        self._proc = None
        self._ready = False
        self._broken = False
        self.spawn_count = 0
        # replayed by respawn(), so the proxies survive a child's death
        self._deployments: Dict[str, dict] = {}
        if start:
            self.start()

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        ctx = multiprocessing.get_context("spawn")
        parent_conn, child_conn = ctx.Pipe(duplex=True)
        self.spawn_count += 1
        # segment names carry (parent pid, group, incarnation, side): a dead
        # incarnation's leftovers are reaped by prefix and never collide
        # with its replacement's
        base = f"pxl{os.getpid()}g{self.group_id}s{self.spawn_count}"
        self._child_prefix = base + "c"
        self._transport = shmt.Transport(prefix=base + "p",
                                         enabled=self.shm_enabled,
                                         threshold=self.shm_threshold)
        cfg = {"group_id": self.group_id, "env": self.env,
               "slice_index": self.slice_index, "node_id": self.node_id,
               "devices": self.devices, "device_ids": self.device_ids,
               "shm": {"enabled": self.shm_enabled,
                       "threshold": self.shm_threshold,
                       "prefix": self._child_prefix}}
        proc = ctx.Process(target=_group_main, args=(child_conn, cfg),
                           name=f"plexrl-g{self.group_id}", daemon=True)
        proc.start()
        child_conn.close()             # our copy: EOF now tracks the child
        self._conn, self._proc = parent_conn, proc
        self._ready = False
        self._broken = False

    def _ensure_ready(self, timeout: float = 180.0) -> None:
        if self._ready:
            return
        if not self._conn.poll(timeout):
            raise GroupProcessError(
                f"group {self.group_id} worker process sent no ready "
                f"handshake within {timeout}s")
        kind, _pid = _recv(self._conn)
        if kind != "ready":
            raise GroupProcessError(
                f"group {self.group_id}: bad handshake {kind!r}")
        self._ready = True

    def alive(self) -> bool:
        # ``_broken`` covers a child whose channel hit EOF before the OS
        # reaped it: health flips dead the moment a call saw the death
        return (self._proc is not None and not self._broken
                and self._proc.is_alive())

    def pid(self) -> Optional[int]:
        return None if self._proc is None else self._proc.pid

    # ----------------------------------------------------------- protocol
    def call(self, kind: str, payload=None, timeout: Optional[float] = None,
             decode_reply: bool = True):
        """One request/reply round trip; returns ``(value, extra)``. A
        remote exception re-raises here as RuntimeError (the child's
        traceback as ``remote_traceback``); a dead child or a broken
        channel raises :class:`GroupProcessError`.

        Large tensors in ``payload`` go through the parent's shm pool; the
        child's reply acks them. Reply tensors arrive as descriptors over
        the child's pool: ``decode_reply=True`` copies them out and acks
        the child; ``decode_reply=False`` returns the encoded value for
        relaying to another child, and the caller owns the release
        (:meth:`release_segments`)."""
        tr = self._transport
        req_segs: List[str] = []
        with self._lock:
            if self._conn is None:
                raise GroupProcessError(
                    f"group {self.group_id} worker process is shut down")
            try:
                self._ensure_ready()
                if tr is not None and tr.enabled \
                        and kind not in ("ping", "shutdown"):
                    payload, req_segs = tr.encode(payload)
                _send(self._conn, (kind, payload))
                if timeout is not None and not self._conn.poll(timeout):
                    # not released: a slow child may still read them; the
                    # pool keeps them busy until it is destroyed
                    raise GroupProcessError(
                        f"group {self.group_id} worker process did not "
                        f"reply to {kind!r} within {timeout}s")
                status, value, extra = _recv(self._conn)
                if req_segs:
                    tr.release(req_segs)
                if tr is not None and decode_reply:
                    reply_segs = shmt.refs_in(value)
                    if reply_segs:
                        self._seen_child_segs.update(reply_segs)
                        try:
                            value = tr.decode(value, copy=True)
                        finally:
                            self._release_locked(reply_segs)
                elif tr is not None:
                    self._seen_child_segs.update(shmt.refs_in(value))
            except (EOFError, OSError) as e:
                self._broken = True
                if req_segs:       # a dead child: no reader can arrive
                    tr.release(req_segs)
                raise GroupProcessError(
                    f"group {self.group_id} worker process died "
                    f"(pid {self.pid()}, exitcode "
                    f"{None if self._proc is None else self._proc.exitcode}) "
                    f"during {kind!r}") from e
        if status == "err":
            err = RuntimeError(f"[group {self.group_id} process] {value}")
            err.remote_traceback = extra
            if extra:
                logger.debug("group %d remote traceback:\n%s",
                             self.group_id, extra)
            raise err
        return value, extra

    def _release_locked(self, names: List[str]) -> None:
        """Fire-and-forget ``shm_release`` to the child (lock held)."""
        try:
            _send(self._conn, ("shm_release", list(names)))
        except OSError:
            self._broken = True    # reaped by prefix at terminate/respawn

    def release_segments(self, names) -> None:
        """Ack child-pool segments consumed outside :meth:`call` (relayed
        payloads). A dead or shut-down child's are reaped by prefix
        instead."""
        names = list(names)
        if not names:
            return
        with self._lock:
            if self._conn is None or self._broken:
                return
            self._release_locked(names)

    def ping(self, timeout: float = 5.0) -> Optional[float]:
        """Liveness heartbeat: the round trip in seconds, or None while a
        dispatch thread holds the channel (busy, not dead). Raises
        :class:`GroupProcessError` when the child is dead."""
        if not self.alive():
            raise GroupProcessError(
                f"group {self.group_id} worker process is not alive "
                f"(exitcode {None if self._proc is None else self._proc.exitcode})")
        if not self._lock.acquire(timeout=timeout):
            return None
        try:
            nonce = next(_nonce)
            t0 = time.monotonic()
            value, _ = self.call("ping", nonce, timeout=timeout)
            if value != nonce:
                raise GroupProcessError(
                    f"group {self.group_id}: heartbeat nonce mismatch")
            return time.monotonic() - t0
        finally:
            self._lock.release()

    # --------------------------------------------------------- deployments
    def create_deployment(self, spec, factory: Optional[str] = None) -> None:
        payload = {"spec": spec,
                   "factory": factory if factory is not None
                   else self.wpg_factory}
        self.call("create_deployment", payload)
        self._deployments[spec.deployment_id] = payload

    def drop_deployment(self, dep_id: str) -> None:
        self._deployments.pop(dep_id, None)
        try:
            self.call("drop_deployment", {"dep": dep_id})
        except GroupProcessError:
            pass                       # a dead child holds nothing to drop

    # ------------------------------------------------- shutdown / respawn
    def shutdown(self, timeout: float = 10.0) -> None:
        """Graceful stop (protocol shutdown, join), escalating to terminate
        and kill. Safe twice and on a dead child."""
        proc = self._proc
        if proc is None:
            return
        if proc.is_alive() and self._lock.acquire(timeout=timeout):
            try:
                _send(self._conn, ("shutdown", None))
                if self._conn.poll(timeout):
                    _recv(self._conn)
            except (EOFError, OSError):
                pass
            finally:
                self._lock.release()
        proc.join(timeout=timeout)
        self._terminate()

    def _terminate(self) -> None:
        proc, conn = self._proc, self._conn
        self._proc = self._conn = None
        self._ready = False
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        if proc is not None:
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5.0)
        self._reap_shm()

    def _reap_shm(self) -> None:
        """Drop every segment of the (gone) incarnation: the parent's pool
        is unlinked, the child's leftovers (its free pool and reply
        segments it never got to release) are swept by name prefix. A
        graceful child already unlinked its own; the sweep finds
        nothing."""
        tr, self._transport = self._transport, None
        if tr is not None:
            tr.close()
        if self._child_prefix:
            reaped = shmt.reap_prefix(self._child_prefix,
                                      tracked=self._seen_child_segs)
            if reaped:
                logger.warning(
                    "group %d: reaped %d orphaned shm segment(s) from dead "
                    "worker process", self.group_id, len(reaped))
        self._seen_child_segs.clear()

    def spill_dir(self) -> str:
        """The child's StateManager's ``disk_dir`` (its default)."""
        return os.path.join(tempfile.gettempdir(), f"plexrl_{self.node_id}")

    def sweep_spill_files(self) -> List[str]:
        """Unlink orphaned migration spill files (``export__*.npy``) in the
        child's spill directory. A completed import consumed its spills and
        a failed transfer's caller removed them, so what is left belonged
        to a transfer of a crashed process."""
        removed = []
        for path in glob.glob(os.path.join(self.spill_dir(),
                                           "export__*.npy")):
            try:
                os.unlink(path)
                removed.append(path)
            except OSError:
                pass
        if removed:
            logger.warning("group %d: swept %d orphaned spill file(s)",
                           self.group_id, len(removed))
        return removed

    def respawn(self) -> None:
        """Replace a dead (or wedged) worker process in place: a new process
        on the same handle (the same environment, devices and device ids)
        with the deployments replayed, so existing
        :class:`WPGProxy` objects stay valid. Managed state is LOST (a
        device failure): jobs re-init or restore a checkpoint. Billing
        survives in the parent's ExecLog mirrors. The dead incarnation's
        segments and spill files go first."""
        with self._lock:
            self._terminate()
            self.sweep_spill_files()
            self.start()
            for payload in self._deployments.values():
                self.call("create_deployment", payload)


class StateManagerProxy:
    """The parent's view of a group process's StateManager: the surface
    the Router's switch, teardown, retire and migration code reads,
    forwarded over the pipe. ``mesh_slice`` is the parent's leased slice;
    the entries live in the child.

    Lifecycle calls (``keys_for`` / ``unregister`` / ``entries``) tolerate a
    dead child, so the teardown of a crashed group completes; the dispatch
    path's queries raise, so a dead group fails its ops fast."""

    def __init__(self, gp: GroupProcess, mesh_slice=None,
                 node_id: Optional[str] = None):
        self.gp = gp
        self.mesh_slice = mesh_slice
        self.node_id = node_id or gp.node_id
        self.last_migrate: Optional[Dict[str, Any]] = None

    # ------------------------------------------------- dispatch-path stats
    def job_bytes(self, job_id: str) -> int:
        return self.gp.call("job_bytes", {"job": job_id})[0]

    @property
    def bytes_moved(self) -> Dict[str, int]:
        return self.gp.call("bytes_moved")[0]

    def load_time_estimate(self, nbytes: int) -> float:
        return self.gp.call("load_estimate", {"nbytes": int(nbytes)})[0]

    def offload_time_estimate(self, nbytes: int) -> float:
        return self.gp.call("offload_estimate", {"nbytes": int(nbytes)})[0]

    # ----------------------------------------------------------- lifecycle
    def keys_for(self, job_id: str, prefix=None) -> List[str]:
        try:
            return self.gp.call("keys_for",
                                {"job": job_id, "prefix": prefix})[0]
        except GroupProcessError:
            return []

    def unregister(self, keys) -> None:
        keys = list(keys)
        if not keys:
            return
        try:
            self.gp.call("unregister", {"keys": keys})
        except GroupProcessError:
            logger.warning("group %d process dead; dropping unregister of "
                           "%d keys", self.gp.group_id, len(keys))

    @property
    def entries(self) -> Dict[str, None]:
        """The keys only (what ``retire_group`` reads); an entry's tier
        and tensor never leave the child."""
        try:
            return dict.fromkeys(self.gp.call("all_keys", None)[0])
        except GroupProcessError:
            return {}

    # ----------------------------------------------------------- migration
    def migrate(self, job_id: str, dst: "StateManagerProxy",
                max_inline_bytes: Optional[int] = None) -> int:
        """Cross-process migration: export in the source child, import in
        the destination child (laid out on ITS slice), then drop the
        source's entries. ``cross_mesh`` compares the two groups' slices
        with ``MeshSlice.crosses``, as ``StateManager.migrate`` does: two
        slices of virtual devices on one card share the card, not the ids.
        With the shm transport the export's tensors land in the source
        child's pool and the parent relays the descriptors: written once
        and read once, both in children. The ``export__*.npy`` spill
        tier takes every entry above ``max_inline_bytes`` (by default only
        when shm is off, at 64 MiB). Transactional: a failed or crashed
        import leaves the source the sole owner, and the parent deletes the
        transfer's spill files (on success the importer consumed them)."""
        if not isinstance(dst, StateManagerProxy):
            raise RuntimeError(
                "process-plane migration needs both groups in process mode")
        if max_inline_bytes is None:
            max_inline_bytes = (1 << 62) if self.gp.shm_enabled else 64 << 20
        t0 = time.monotonic()
        payload, _ = self.gp.call(
            "migrate_export", {"job": job_id, "max_inline": max_inline_bytes},
            decode_reply=False)
        segs = shmt.refs_in(payload)
        t1 = time.monotonic()
        try:
            moved, _ = dst.gp.call("migrate_import", {"payload": payload})
        except BaseException:
            # the import never committed: the spills are ours to delete
            _unlink_spills(payload)
            raise
        finally:
            # the importer synchronised before its reply, or died: either
            # way the source's segments are done
            self.gp.release_segments(segs)
        t2 = time.monotonic()
        self.gp.call("drop_job_state", {"job": job_id})
        src_sl, dst_sl = self.mesh_slice, dst.mesh_slice
        cross = (src_sl is not None and dst_sl is not None
                 and src_sl.crosses(dst_sl))
        self.last_migrate = {
            "bytes": moved, "seconds": time.monotonic() - t0,
            "cross_mesh": cross, "keys": len(payload["entries"]),
            "export_seconds": t1 - t0, "import_seconds": t2 - t1,
            "spilled": sum(e["path"] is not None
                           for e in payload["entries"]),
            "shm": bool(segs)}
        return moved


class WPGProxy:
    """What ``Router.wpgs[dep]`` holds in process mode: the WPG surface
    forwarded over the group's pipe, so dispatch, context switches,
    teardown, billing and migration run unchanged against it."""

    def __init__(self, spec, sm: StateManagerProxy):
        from repro_torch.core.worker import ExecLog
        self.spec = spec
        self._sm = sm
        # the billing mirror, appended on completion: a child's death
        # cannot lose the entries of ops that finished
        self.exec_log = ExecLog()
        sm.gp.create_deployment(spec)

    @property
    def gp(self) -> GroupProcess:
        return self._sm.gp

    @property
    def job_prefix(self) -> str:
        return f"{self.spec.job_id}:{self.spec.deployment_id}"

    @property
    def mesh_slice(self):
        return self._sm.mesh_slice

    @property
    def sm(self) -> StateManagerProxy:
        return self._sm

    @sm.setter
    def sm(self, new_sm: StateManagerProxy):
        """Migration rehome (``Router.migrate_job`` sets ``wpg.sm = dst``):
        re-create the deployment's WPG in the destination child, whose
        StateManager already holds the imported entries under the same
        keys, and drop the source child's."""
        if new_sm is self._sm:
            return
        old_gp = self._sm.gp
        new_sm.gp.create_deployment(self.spec)
        if new_sm.gp is not old_gp:
            old_gp.drop_deployment(self.spec.deployment_id)
        self._sm = new_sm

    # ------------------------------------------------------- WPG protocol
    def resident(self) -> bool:
        return self.gp.call("resident", {"dep": self.spec.deployment_id})[0]

    def ensure_resident(self) -> float:
        return self.gp.call("ensure_resident",
                            {"dep": self.spec.deployment_id})[0]

    def offload(self, to=None) -> float:
        tier = 1 if to is None else int(to)
        return self.gp.call("offload", {"dep": self.spec.deployment_id,
                                        "tier": tier})[0]

    def execute(self, qop):
        """Run one admitted op in the child. Its future arguments are
        already spliced, so everything shipped is plain data. A
        SYNC_WEIGHTS target in the same child goes as a deployment-id
        marker; one in another child is relayed here (sync_export in the
        source, store_params in the target)."""
        args = tuple(qop.args)
        if qop.op.value == "sync_weights" and args \
                and isinstance(args[0], WPGProxy):
            target = args[0]
            if target.gp is not self.gp:
                return self._sync_cross_process(
                    target, qop.kwargs.get("target_shardings"))
            args = (("__dep__", target.spec.deployment_id),) + args[1:]
        payload = {"dep": qop.deployment_id, "req_id": qop.req_id,
                   "job_id": qop.job_id, "op": qop.op.value,
                   "args": args, "kwargs": dict(qop.kwargs)}
        try:
            result, entry = self.gp.call("execute", payload)
        except GroupProcessError as e:
            raise RuntimeError(
                f"group {self.gp.group_id} worker process died executing "
                f"op {qop.req_id} ({qop.op.value})") from e
        if entry is not None:
            self.exec_log.append(tuple(entry))
        return result

    def _sync_cross_process(self, target: "WPGProxy", target_shardings=None):
        """A weight sync across children as a descriptor relay: the source
        child writes its host parameters once into its shm pool (a slice's
        gathered), the parent forwards the descriptors without touching the
        bytes, and the target child lays them out on its slice (in
        ``target_shardings``, a tree of ``NamedSharding`` over the target's
        slice, or its deployment's own layout), synchronising before it
        replies.
        The reply releases the segments to the source; a target that dies
        mid-store still releases them (a dead source's are reaped)."""
        t0 = time.monotonic()
        tree, _ = self.gp.call("sync_export",
                               {"dep": self.spec.deployment_id},
                               decode_reply=False)
        segs = shmt.refs_in(tree)
        try:
            target.gp.call("store_params",
                           {"dep": target.spec.deployment_id, "tree": tree,
                            "shardings": target_shardings})
        finally:
            self.gp.release_segments(segs)
        synced = self._sm.job_bytes(self.job_prefix)
        self.exec_log.append(("sync_weights", time.monotonic() - t0))
        return {"synced_bytes": synced}

    def close(self) -> None:
        """Drop the child's WPG (``Router.teardown`` calls this once the
        managed state is unregistered)."""
        self.gp.drop_deployment(self.spec.deployment_id)
