"""The port's shared-memory transport (repro_torch/launch/shm_transport.py)
in isolation, held against the reference's.

Each test of tests/test_shm_transport.py, on torch tensors: pool mechanics
(alloc, reuse, high-water trim, destroy, monotonic names), the
encode/decode round trip over nested trees (threshold split, bf16 bit-exact
without ml_dtypes, non-contiguous sources, namedtuples, a shared leaf
written once), the pickle-path passthroughs and crash reaping by name
prefix. The descriptors of one tree are the reference's: the same offsets,
shapes, dtype strings and sizes.
"""
import collections
import dataclasses
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.launch import shm_transport as ref_shmt
from repro_torch.launch import shm_transport as shmt

pytestmark = pytest.mark.skipif(
    not shmt.shm_available(), reason="no usable shared memory on this host")


def shm_names(prefix: str):
    """Live /dev/shm entries under a test's segment prefix."""
    try:
        return sorted(n for n in os.listdir(shmt.SHM_DIR)
                      if n.startswith(prefix))
    except FileNotFoundError:
        return []


def owns_memory(t: torch.Tensor) -> bool:
    """A tensor over a mapped segment has a fixed external storage; a copy
    has its own, resizable one."""
    return t.untyped_storage().resizable()


# ------------------------------------------------------------------- pool
def test_pool_alloc_reuse_and_trim():
    pool = shmt.SegmentPool("tt-pool", max_pool_bytes=64 << 20,
                            max_free_segments=2)
    try:
        a = pool.alloc(1 << 20)
        assert a.size >= 1 << 20 and pool.busy_count() == 1
        pool.release([a.name])
        b = pool.alloc(1 << 20)
        assert b.name == a.name and pool.created == 1 and pool.reused == 1
        c = pool.alloc(4 << 20)
        assert c.name != b.name
        pool.release([b.name, c.name])
        d = pool.alloc(8 << 20)
        e = pool.alloc(16 << 20)
        pool.release([d.name, e.name])
        assert len(pool.names()) <= pool.busy_count() + 2
        assert e.name not in shm_names("tt-pool")     # largest trimmed
    finally:
        pool.destroy()
    assert shm_names("tt-pool") == []


def test_pool_release_unknown_name_is_noop():
    pool = shmt.SegmentPool("tt-noop")
    try:
        assert pool.release(["tt-noop-999", "someone-else"]) == 0
    finally:
        pool.destroy()


def test_pool_high_water_bytes():
    pool = shmt.SegmentPool("tt-hw", max_pool_bytes=2 << 20,
                            max_free_segments=8)
    try:
        segs = [pool.alloc(1 << 20) for _ in range(4)]
        pool.release([s.name for s in segs])
        assert pool.free_bytes() <= 2 << 20
    finally:
        pool.destroy()


# -------------------------------------------------------- encode / decode
Point = collections.namedtuple("Point", "x y")


def test_roundtrip_nested_tree():
    pool = shmt.SegmentPool("tt-rt")
    cache = shmt.SegmentCache()
    big = torch.arange(1 << 18, dtype=torch.float32)       # 1 MiB
    small = torch.arange(16, dtype=torch.int64)            # under threshold
    tree = {"a": big, "b": {"c": small, "d": [big * 2, "text", 7]},
            "p": Point(x=big * 3, y=None)}
    try:
        enc, segs = shmt.encode(tree, pool, threshold=64 << 10)
        assert len(segs) == 1
        assert isinstance(enc["a"], shmt.ShmRef)
        assert isinstance(enc["b"]["c"], torch.Tensor)
        assert isinstance(enc["p"], Point)
        assert shmt.has_refs(enc) and shmt.refs_in(enc) == segs
        dec = shmt.decode(enc, cache, copy=True)
        assert torch.equal(dec["a"], big)
        assert torch.equal(dec["b"]["d"][0], big * 2)
        assert torch.equal(dec["p"].x, big * 3)
        assert dec["b"]["d"][1] == "text" and dec["p"].y is None
        assert owns_memory(dec["a"])          # releasing cannot corrupt it
        pool.release(segs)
    finally:
        cache.close()
        pool.destroy()


def test_decode_views_are_zero_copy():
    pool = shmt.SegmentPool("tt-view")
    cache = shmt.SegmentCache()
    t = torch.arange(1 << 18, dtype=torch.float32)
    try:
        enc, segs = shmt.encode({"w": t}, pool, threshold=1024)
        dec = shmt.decode(enc, cache, copy=False)
        assert not owns_memory(dec["w"])                   # a view
        assert torch.equal(dec["w"], t)
        del dec                                            # drop the view…
        pool.release(segs)
    finally:
        cache.close()                                      # …before unmap
        pool.destroy()


def test_bf16_wire_roundtrip():
    """bf16 travels under "bfloat16" and comes back bit-exact, as a torch
    tensor, with no ml_dtypes on the port's side."""
    pool = shmt.SegmentPool("tt-bf16")
    cache = shmt.SegmentCache()
    t = torch.linspace(-4, 4, 1 << 17).to(torch.bfloat16)
    try:
        enc, segs = shmt.encode({"p": t}, pool, threshold=1024)
        ref = enc["p"]
        assert ref.dtype == "bfloat16" and ref.nbytes == t.numel() * 2
        dec = shmt.decode(enc, cache, copy=True)
        assert dec["p"].dtype == torch.bfloat16
        assert torch.equal(dec["p"].view(torch.int16), t.view(torch.int16))
        pool.release(segs)
    finally:
        cache.close()
        pool.destroy()


def test_non_contiguous_source():
    pool = shmt.SegmentPool("tt-nc")
    cache = shmt.SegmentCache()
    base = torch.arange(1 << 18, dtype=torch.float64).reshape(512, 512)
    sliced = base[::2, ::2]
    assert not sliced.is_contiguous()
    try:
        enc, segs = shmt.encode({"s": sliced}, pool, threshold=1024)
        dec = shmt.decode(enc, cache, copy=True)
        assert torch.equal(dec["s"], sliced)
        pool.release(segs)
    finally:
        cache.close()
        pool.destroy()


def test_shared_leaf_written_once():
    pool = shmt.SegmentPool("tt-shared")
    cache = shmt.SegmentCache()
    t = torch.ones(1 << 18)
    try:
        enc, segs = shmt.encode({"a": t, "b": t}, pool, threshold=1024)
        assert enc["a"] is enc["b"]                        # one descriptor
        dec = shmt.decode(enc, cache, copy=True)
        assert torch.equal(dec["a"], dec["b"])
        pool.release(segs)
    finally:
        cache.close()
        pool.destroy()


def test_threshold_and_passthrough():
    pool = shmt.SegmentPool("tt-thresh")
    small_tree = {"x": torch.arange(8, dtype=torch.float32), "y": 3}
    try:
        enc, segs = shmt.encode(small_tree, pool, threshold=1 << 20)
        assert segs == [] and enc is small_tree
        assert not shmt.has_refs(enc)
        enc2, segs2 = shmt.encode({"w": torch.ones(1 << 20)}, None)
        assert segs2 == [] and not shmt.has_refs(enc2)
        objs = np.array([{"k": 1}, None], dtype=object)
        enc3, segs3 = shmt.encode({"o": objs}, pool, threshold=0)
        assert segs3 == []
        assert shmt.decode(small_tree, shmt.SegmentCache()) is small_tree
        # a device tensor never reaches the transport: it is staged first
        with pytest.raises(TypeError, match="stage it to the host"):
            shmt.encode({"m": torch.ones(1 << 10, device="meta")}, pool,
                        threshold=0)
    finally:
        pool.destroy()


def test_transport_bundle_disabled_is_noop():
    tr = shmt.Transport(prefix="tt-off", enabled=False)
    big = {"w": torch.ones(1 << 20)}
    enc, segs = tr.encode(big)
    assert enc is big and segs == [] and tr.pool_names() == []
    tr.close()
    assert shm_names("tt-off") == []


# ----------------------------------------------------------------- reaping
def test_reap_prefix_scan_and_tracked_fallback():
    pool = shmt.SegmentPool("tt-reap")
    a = pool.alloc(1 << 20)
    b = pool.alloc(1 << 20)
    names = [a.name, b.name]
    del pool                  # the owner dies without cleanup
    assert set(shm_names("tt-reap")) == set(names)
    assert set(shmt.reap_prefix("tt-reap", tracked=names)) == set(names)
    assert shm_names("tt-reap") == []
    assert shmt.reap_prefix("tt-reap", tracked=names) == []
    other = shmt.SegmentPool("tt-keep")
    keep = other.alloc(1 << 20)
    try:
        assert shmt.reap_prefix("tt-reap", tracked=[keep.name]) == []
        assert shm_names("tt-keep") == [keep.name]
    finally:
        other.destroy()


def test_segment_cache_lru_eviction():
    pool = shmt.SegmentPool("tt-lru", max_free_segments=16,
                            max_pool_bytes=1 << 30)
    cache = shmt.SegmentCache(max_entries=2)
    try:
        segs = [pool.alloc(1 << 20) for _ in range(3)]
        for s in segs:
            np.ndarray(4, np.float32, buffer=s.buf)[:] = 1.0
            ref = shmt.ShmRef(segment=s.name, offset=0, shape=(4,),
                              dtype="<f4", nbytes=16)
            assert torch.equal(cache.view(ref), torch.ones(4))
        assert len(cache._shms) <= 2
        assert cache.seen == {s.name for s in segs}
    finally:
        cache.close()
        pool.destroy()


# ------------------------------------------------- against the reference
def test_descriptors_equal_the_reference_for_one_tree():
    """The same tree (f32, bf16, int32, bool, a non-contiguous slice, a
    shared leaf, a namedtuple and small leaves under the threshold) encodes
    to the reference's descriptors: offsets, shapes, dtype strings, sizes;
    the bytes in the two segments are equal too."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((64, 96)).astype(np.float32)
    bf = rng.standard_normal((300, 70)).astype(ml_dtypes.bfloat16)
    i32 = rng.integers(-9, 9, size=(4096,)).astype(np.int32)
    flags = rng.random(5000) > 0.5
    wide = rng.standard_normal((200, 300))[::2, ::3]
    small = np.arange(5, dtype=np.int64)

    def tree(conv):
        shared = conv(f32)
        return {"w": shared, "again": shared, "bf": conv(bf),
                "n": {"i": conv(i32), "mask": conv(flags)},
                "p": Point(x=conv(wide), y=conv(small)), "s": "text"}

    def to_torch(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))

    ref_pool, pool = ref_shmt.SegmentPool("tr-ref"), shmt.SegmentPool("tt-d")
    ref_cache, cache = ref_shmt.SegmentCache(), shmt.SegmentCache()
    try:
        ref_enc, ref_segs = ref_shmt.encode(tree(lambda a: a), ref_pool,
                                            threshold=1024)
        enc, segs = shmt.encode(tree(to_torch), pool, threshold=1024)
        ref_refs, refs = [], []
        ref_shmt._walk(ref_enc, ref_refs.append)
        shmt._walk(enc, refs.append)
        assert len(refs) == len(ref_refs)
        for mine, theirs in zip(refs, ref_refs):
            if isinstance(theirs, ref_shmt.ShmRef):
                assert (mine.offset, mine.shape, mine.dtype, mine.nbytes) == (
                    theirs.offset, theirs.shape, theirs.dtype, theirs.nbytes)
            else:
                assert not isinstance(mine, shmt.ShmRef)
        n = max(r.offset + r.nbytes for r in ref_refs
                if isinstance(r, ref_shmt.ShmRef))
        mine = bytes(cache.attach(segs[0]).buf[:n])
        theirs = bytes(ref_cache.attach(ref_segs[0]).buf[:n])
        assert mine == theirs
        # the reference's bf16 descriptor decodes bit-exact here
        got = shmt.decode(shmt.ShmRef(**dataclasses.asdict(ref_enc["bf"])),
                          cache)
        assert torch.equal(got.view(torch.int16),
                           torch.from_numpy(bf.view(np.int16)))
    finally:
        for c in (cache, ref_cache):
            c.close()
        for p in (pool, ref_pool):
            p.destroy()
