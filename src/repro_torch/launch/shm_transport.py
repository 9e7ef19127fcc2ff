"""Shared-memory tensor transport for the process plane.

The port of ``repro.launch.shm_transport``. Large host tensors in a
process-plane request or reply do not travel through the pipe: the writer
copies them once into a pooled ``multiprocessing.shared_memory`` segment
and the pipe carries :class:`ShmRef` descriptors ``(segment, offset,
shape, dtype, nbytes)``; the reader maps the segment and copies the bytes
out, or lands them straight on its device, from a view.

- **Pooling** (:class:`SegmentPool`): all of one message's large tensors
  pack into one segment sized to the next power of two; a released
  segment returns to a free list bounded by ``max_pool_bytes`` /
  ``max_free_segments`` (trimmed largest first).
- **Release acks**: a segment is busy from ``encode`` until its consumer
  acks it. For a parent -> child request the child's reply is the ack
  (its handlers consume before they reply); a child -> parent reply is
  acked by a ``shm_release`` frame once the parent has decoded it; a
  payload relayed from one child to another is released to its writer
  after the destination's reply.
- **Crash reaping**: segment names carry (parent pid, group, incarnation,
  side), ``pxl{pid}g{gid}s{n}{side}-{seq}``, so the parent unlinks every
  segment of a dead child by prefix (:func:`reap_prefix`).
- **Threshold**: tensors below ``threshold`` bytes, or every tensor when
  the transport is off, ride the pickle path.

Tensors travel by their bytes: a torch CPU tensor (or a numpy array, what
a torch-free stub child sends) is written into the segment whatever its
layout, and its descriptor carries the numpy dtype string
(``arr.dtype.str``); bfloat16, which numpy lacks, travels under
``"bfloat16"``. CUDA tensors never reach :func:`encode`: a child stages
them to the host first. Decoding in a process that has torch loaded gives
torch tensors (bfloat16 always does), in a torch-free one numpy arrays.

A view holds the segment's buffer: ``SharedMemory.close`` raises
``BufferError`` while one lives, so the cache keeps such a mapping and the
consumer drops its views before it acks.

Module-level imports are stdlib-only: a spawned group process imports this
(through ``launch.proc_plane``) before it applies its device environment.
"""
from __future__ import annotations

import dataclasses
import math
import os
import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

# the reference's pickle-vs-shm crossover, 32-128 KiB measured on one host
# (BENCH_PR10.json), an octave above for trees of many borderline tensors
DEFAULT_THRESHOLD = 256 << 10
DEFAULT_POOL_BYTES = 1 << 30          # high-water mark per pool (free bytes)
DEFAULT_FREE_SEGMENTS = 4             # free-list length cap
_ALIGN = 64                           # offsets are cache-line aligned
_MIN_SEGMENT = 1 << 20                # round tiny packs up for better reuse
SHM_DIR = "/dev/shm"


def _round_segment(nbytes: int) -> int:
    """Next power of two, floored at ``_MIN_SEGMENT``."""
    size = _MIN_SEGMENT
    while size < nbytes:
        size <<= 1
    return size


def _untrack(shm) -> None:
    """Opt a segment out of ``resource_tracker`` right after create or
    attach: the tracker registers on attach too (bpo-39959), so an
    attacher's exit would unlink segments their creator still owns. Pools
    unlink on destroy and parents reap dead children by prefix instead;
    :func:`_destroy_segment` re-registers just before ``unlink()`` so the
    tracker's books balance."""
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:  # noqa: BLE001 - best-effort on every platform
        pass


def shm_available() -> bool:
    """True when pooled shared-memory transport can run here: a segment
    can be created and ``PLEXRL_SHM`` does not turn it off."""
    if os.environ.get("PLEXRL_SHM", "").lower() in ("0", "off", "false"):
        return False
    try:
        from multiprocessing import shared_memory
        probe = shared_memory.SharedMemory(create=True, size=_ALIGN)
        probe.close()
        probe.unlink()
        return True
    except Exception:  # noqa: BLE001 - any failure means "use pickle"
        return False


# --------------------------------------------------------------- descriptor
@dataclasses.dataclass(frozen=True)
class ShmRef:
    """What the pipe carries instead of a tensor: where its bytes live.
    ``dtype`` is the numpy dtype string, or ``"bfloat16"``."""
    segment: str
    offset: int
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int


def _is_tensor(x) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _big_nbytes(x, threshold: int) -> Optional[int]:
    """The bytes of a tensor or array leaf that rides shm, else None."""
    if _is_tensor(x):
        if x.device.type != "cpu":
            raise TypeError(
                f"a {x.device} tensor reached the shm transport: stage it to "
                "the host first")
        n = x.numel() * x.element_size()
        return n if n >= threshold else None
    np = sys.modules.get("numpy")
    if (np is not None and isinstance(x, np.ndarray)
            and not x.dtype.hasobject and x.nbytes >= threshold):
        return x.nbytes
    return None


def _wire_dtype(x) -> str:
    if _is_tensor(x):
        import torch
        if x.dtype == torch.bfloat16:
            return "bfloat16"
        return torch.empty((), dtype=x.dtype).numpy().dtype.str
    return "bfloat16" if x.dtype.name == "bfloat16" else x.dtype.str


def _write(x, buf, offset: int) -> None:
    """Copy a leaf's bytes into ``buf`` at ``offset``, any source layout."""
    if _is_tensor(x):
        import torch
        if x.numel():
            dst = torch.frombuffer(buf, dtype=x.dtype, count=x.numel(),
                                   offset=offset)
            dst.view(x.shape).copy_(x.detach())
        return
    import numpy as np
    wire = x.view(np.uint16) if x.dtype.name == "bfloat16" else x
    np.copyto(np.ndarray(wire.shape, dtype=wire.dtype, buffer=buf,
                         offset=offset), wire)


def _torch_dtype(wire: str):
    import numpy as np
    import torch
    if wire == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(wire))).dtype


# ---------------------------------------------------------------- free pool
class SegmentPool:
    """Writer-side pool of named shared-memory segments.

    ``alloc`` prefers the smallest free segment that fits; a miss creates a
    new segment named ``{prefix}-{seq}`` (names are never reused, so a
    stale reader-side attachment never aliases new data). ``release``
    returns segments to the free list, trimming it under the high-water
    mark largest first. Thread-safe: per-group dispatch threads drive the
    parent's side."""

    def __init__(self, prefix: str,
                 max_pool_bytes: int = DEFAULT_POOL_BYTES,
                 max_free_segments: int = DEFAULT_FREE_SEGMENTS):
        self.prefix = prefix
        self.max_pool_bytes = max_pool_bytes
        self.max_free_segments = max_free_segments
        self._seq = 0
        self._free: List[Any] = []         # SharedMemory, sorted by size
        self._busy: Dict[str, Any] = {}    # name -> SharedMemory
        self._lock = threading.Lock()
        self.created = 0                   # segments ever created
        self.reused = 0                    # allocs served from the free list

    def alloc(self, nbytes: int):
        """A segment with capacity >= nbytes, busy until released."""
        from multiprocessing import shared_memory
        with self._lock:
            fit = [s for s in self._free if s.size >= nbytes]
            if fit:
                shm = min(fit, key=lambda s: s.size)
                self._free.remove(shm)
                self._busy[shm.name] = shm
                self.reused += 1
                return shm
            self._seq += 1
            name = f"{self.prefix}-{self._seq}"
        shm = shared_memory.SharedMemory(
            name=name, create=True, size=_round_segment(nbytes))
        _untrack(shm)
        with self._lock:
            self._busy[shm.name] = shm
            self.created += 1
        return shm

    def release(self, names) -> int:
        """Return busy segments to the free list (the consumer's ack),
        enforcing the high-water mark. Unknown names are ignored: a release
        can race a pool a respawn destroyed."""
        victims = []
        n = 0
        with self._lock:
            for name in names:
                shm = self._busy.pop(name, None)
                if shm is None:
                    continue
                self._free.append(shm)
                n += 1
            self._free.sort(key=lambda s: s.size)
            while (len(self._free) > self.max_free_segments
                   or sum(s.size for s in self._free) > self.max_pool_bytes):
                victims.append(self._free.pop())   # largest first
        for shm in victims:
            _destroy_segment(shm)
        return n

    def names(self) -> List[str]:
        with self._lock:
            return list(self._busy) + [s.name for s in self._free]

    def free_bytes(self) -> int:
        with self._lock:
            return sum(s.size for s in self._free)

    def busy_count(self) -> int:
        with self._lock:
            return len(self._busy)

    def destroy(self) -> None:
        """Unlink everything, busy included (only once no reader can still
        arrive: the child's exit, or the parent's teardown of a dead
        child)."""
        with self._lock:
            segs = list(self._busy.values()) + self._free
            self._busy.clear()
            self._free = []
        for shm in segs:
            _destroy_segment(shm)


def _destroy_segment(shm) -> None:
    try:
        shm.close()
    except (BufferError, OSError):
        pass
    try:
        from multiprocessing import resource_tracker
        resource_tracker.register(shm._name, "shared_memory")
    except Exception:  # noqa: BLE001
        pass
    try:
        shm.unlink()
    except OSError:
        _untrack(shm)    # unlink raised before its internal unregister ran


# ------------------------------------------------------------ reader cache
class SegmentCache:
    """Receiver-side attachments by segment name, a bounded LRU: pool
    recycling repeats the same few names, so the steady-state receive path
    maps nothing. An evicted mapping that a view still holds stays mapped
    (``BufferError``) until a later eviction."""

    def __init__(self, max_entries: int = 8):
        self.max_entries = max_entries
        self._shms: Dict[str, Any] = {}
        self._order: List[str] = []
        self.seen: set = set()       # every name ever attached (the reap
        #                              fallback where /dev/shm is unscannable)

    def attach(self, name: str):
        shm = self._shms.get(name)
        if shm is None:
            from multiprocessing import shared_memory
            shm = shared_memory.SharedMemory(name=name)
            _untrack(shm)
            self._shms[name] = shm
            self.seen.add(name)
            self._order.append(name)
            while len(self._order) > self.max_entries:
                old = self._order.pop(0)
                if old == name:
                    self._order.append(name)
                    continue
                dead = self._shms.pop(old, None)
                if dead is not None:
                    try:
                        dead.close()
                    except BufferError:     # a view survived: keep mapped
                        self._shms[old] = dead
                        self._order.insert(0, old)
                        break
        else:
            self._order.remove(name)
            self._order.append(name)
        return shm

    def view(self, ref: ShmRef):
        """A tensor (numpy array in a torch-free process) straight over the
        shared buffer: no copy. The caller consumes it before the release."""
        shm = self.attach(ref.segment)
        if "torch" in sys.modules or ref.dtype == "bfloat16":
            import torch
            dtype = _torch_dtype(ref.dtype)
            n = math.prod(ref.shape)
            if n == 0:
                return torch.empty(ref.shape, dtype=dtype)
            return torch.frombuffer(shm.buf, dtype=dtype, count=n,
                                    offset=ref.offset).view(ref.shape)
        import numpy as np
        return np.ndarray(ref.shape, dtype=np.dtype(ref.dtype),
                          buffer=shm.buf, offset=ref.offset)

    def close(self) -> None:
        for shm in self._shms.values():
            try:
                shm.close()
            except (BufferError, OSError):
                pass
        self._shms.clear()
        self._order = []


# ----------------------------------------------------------- encode/decode
def _walk(obj, fn: Callable[[Any], Any]):
    """Structure-preserving transform over the containers that cross the
    pipe (dict / list / tuple / namedtuple); everything else is a leaf."""
    if isinstance(obj, dict):
        return {k: _walk(v, fn) for k, v in obj.items()}
    if isinstance(obj, tuple):
        items = [_walk(v, fn) for v in obj]
        if hasattr(obj, "_fields"):            # namedtuple
            return type(obj)(*items)
        return tuple(items)
    if isinstance(obj, list):
        return [_walk(v, fn) for v in obj]
    return fn(obj)


def encode(obj, pool: Optional[SegmentPool],
           threshold: int = DEFAULT_THRESHOLD) -> Tuple[Any, List[str]]:
    """Replace every large tensor or array leaf in ``obj`` with a
    :class:`ShmRef`, packing all of them into ONE pool segment at
    cache-line-aligned offsets. Returns ``(encoded obj, segment names now
    busy)``. A tree with no large leaf, or no pool, passes through
    untouched."""
    if pool is None or ("numpy" not in sys.modules
                        and "torch" not in sys.modules):
        return obj, []
    leaves: List[Tuple[Any, int]] = []

    def collect(x):
        n = _big_nbytes(x, threshold)
        if n is not None:
            leaves.append((x, n))
        return x

    _walk(obj, collect)
    if not leaves:
        return obj, []

    total = 0
    offsets = []
    for _, n in leaves:
        offsets.append(total)
        total += (n + _ALIGN - 1) & ~(_ALIGN - 1)
    shm = pool.alloc(total)

    refs: Dict[int, ShmRef] = {}
    for (x, n), off in zip(leaves, offsets):
        if id(x) in refs:                     # shared leaf: write once
            continue
        _write(x, shm.buf, off)
        refs[id(x)] = ShmRef(segment=shm.name, offset=off,
                             shape=tuple(x.shape), dtype=_wire_dtype(x),
                             nbytes=n)

    def swap(x):
        r = refs.get(id(x))
        return x if r is None else r

    return _walk(obj, swap), [shm.name]


def decode(obj, cache: SegmentCache, copy: bool = True):
    """Materialise :class:`ShmRef` leaves. ``copy=True`` gives owning
    tensors, for results that outlive the message; ``copy=False`` gives
    views for a consumer that copies them out (to its device, or into its
    own tensors) before the segment is released."""
    if not has_refs(obj):
        return obj

    def mat(x):
        if not isinstance(x, ShmRef):
            return x
        view = cache.view(x)
        if not copy:
            return view
        return view.clone() if _is_tensor(view) else view.copy()

    return _walk(obj, mat)


def has_refs(obj) -> bool:
    found = []

    def probe(x):
        if isinstance(x, ShmRef):
            found.append(x)
        return x

    _walk(obj, probe)
    return bool(found)


def refs_in(obj) -> List[str]:
    """Distinct segment names referenced by ``obj`` (the release
    bookkeeping of relayed payloads the parent never decodes)."""
    names: List[str] = []

    def probe(x):
        if isinstance(x, ShmRef) and x.segment not in names:
            names.append(x.segment)
        return x

    _walk(obj, probe)
    return names


# ------------------------------------------------------------ crash reaping
def reap_prefix(prefix: str, tracked=()) -> List[str]:
    """Unlink every shared-memory segment whose name starts with
    ``prefix``: the parent's sweep of a dead incarnation. Scans the shm
    directory where one exists, else the ``tracked`` names. Idempotent."""
    removed: List[str] = []
    if os.path.isdir(SHM_DIR):
        try:
            names = [n for n in os.listdir(SHM_DIR) if n.startswith(prefix)]
        except OSError:
            names = []
        for name in names:
            try:
                os.unlink(os.path.join(SHM_DIR, name))
                removed.append(name)
            except OSError:
                pass
        return removed
    from multiprocessing import shared_memory
    for name in tracked:
        if not name.startswith(prefix):
            continue
        try:
            # attach registers with the tracker and unlink() unregisters:
            # balanced, so no _untrack here
            shm = shared_memory.SharedMemory(name=name)
            shm.close()
            shm.unlink()
            removed.append(name)
        except OSError:
            pass
    return removed


# -------------------------------------------------------------- the bundle
class Transport:
    """One side of a channel: a writer pool (under ``prefix``) and a reader
    cache for the peer's segments. ``enabled=False`` makes every call the
    pickle path's no-op, so callers never branch."""

    def __init__(self, prefix: str, enabled: bool = True,
                 threshold: int = DEFAULT_THRESHOLD,
                 max_pool_bytes: int = DEFAULT_POOL_BYTES):
        self.prefix = prefix
        self.enabled = enabled
        self.threshold = threshold
        self._pool: Optional[SegmentPool] = None
        self._max_pool_bytes = max_pool_bytes
        self.cache = SegmentCache()

    @property
    def pool(self) -> Optional[SegmentPool]:
        if not self.enabled:
            return None
        if self._pool is None:
            self._pool = SegmentPool(self.prefix,
                                     max_pool_bytes=self._max_pool_bytes)
        return self._pool

    def encode(self, obj) -> Tuple[Any, List[str]]:
        if not self.enabled:
            return obj, []
        return encode(obj, self.pool, self.threshold)

    def decode(self, obj, copy: bool = True):
        return decode(obj, self.cache, copy=copy)

    def release(self, names) -> int:
        if self._pool is None or not names:
            return 0
        return self._pool.release(names)

    def pool_names(self) -> List[str]:
        return [] if self._pool is None else self._pool.names()

    def close(self) -> None:
        self.cache.close()
        if self._pool is not None:
            self._pool.destroy()
            self._pool = None
