"""The pool of host blocks that large device-to-host copies land in
(transfer.HostPool, transfer.host_pool) on the CPU.

The CPU build of torch cannot pin, so the pool here takes plain CPU
blocks (a stand-in for the pinned allocation), and transfer._host_block_path is
patched to admit CPU sources from MIN bytes on, so that the codec's own
copies run the pool's logic.  A block is reused only once its array and
every view of it are gone; a result held is never written by a later
call; the smallest free block that fits is taken; past the pool's limit a
copy is left to pageable memory and counted as declined; without the
patch, CPU sources and small copies never reach the pool; fetch fills a
pooled array as it filled a fresh one; and a root span carries the
pool's counts beside the four copy counts.
"""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from huffman_tpu_torch import api, transfer, wide
from huffman_tpu_torch.parallel.mesh import fetch, make_mesh
from huffman_tpu_torch.parallel.pipeline import ShardedCodec
from huffman_tpu_torch.utils import timing

MIN = 4096
LIMIT = 1 << 20
KIB = 1024


@pytest.fixture
def pool(monkeypatch):
    """A pool of plain CPU blocks that records each block it makes, which
    the codec's copies of MIN bytes or more from any device ask."""
    made = []

    def alloc(nbytes):
        made.append(nbytes)
        return torch.empty(nbytes, dtype=torch.uint8)

    p = transfer.HostPool(LIMIT, alloc=alloc)
    p.made = made
    monkeypatch.setattr(transfer, "host_pool", p)
    monkeypatch.setattr(transfer, "_host_block_path",
                        lambda device, nbytes: nbytes >= MIN)
    return p


def _counts() -> dict:
    return {k: c.n for k, c in timing.host_blocks.items()}


def _change(before: dict) -> dict:
    return {k: c.n - before[k] for k, c in timing.host_blocks.items()}


def _ptr(arr: np.ndarray) -> int:
    return arr.__array_interface__["data"][0]


def _data(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.geometric(0.3, size=n) % 40).astype(np.uint8)


def _copy(n: int, fill: int = 7) -> np.ndarray:
    return transfer.to_host(torch.full((n,), fill, dtype=torch.uint8))


# what a caller keeps of a result: the array, or something made from it
HOLD = {
    "array": lambda a: a,
    "u32_view": lambda a: a.view(np.uint32),
    "slice": lambda a: a[100:200],
    "view_of_view": lambda a: a.view(np.uint32)[3:].view(np.uint8),
    "tensor": lambda a: torch.from_numpy(a),
    "memoryview": lambda a: memoryview(a),
}


@pytest.mark.parametrize("hold", HOLD)
def test_block_is_reused_only_after_every_view_is_dropped(pool, hold):
    first = _copy(8 * KIB)
    kept = HOLD[hold](first)
    ptr = _ptr(first)
    del first
    before = _counts()
    second = _copy(8 * KIB, fill=9)
    assert _ptr(second) != ptr                   # the held block is skipped
    assert _change(before) == {"reused": 0, "new": 8 * KIB, "declined": 0}
    assert (np.asarray(kept).view(np.uint8) == 7).all()
    del second, kept
    before = _counts()
    third = _copy(8 * KIB, fill=3)
    assert _ptr(third) in {_ptr(b.numpy()) for b, _ in pool.blocks}
    assert _change(before) == {"reused": 8 * KIB, "new": 0, "declined": 0}
    assert len(pool.made) == 2


def test_result_keeps_the_source_dtype_and_shape(pool):
    src = torch.arange(6 * KIB, dtype=torch.int32).reshape(3, 2 * KIB)
    out = transfer.to_host(src)
    assert out.dtype == np.int32 and out.shape == (3, 2 * KIB)
    np.testing.assert_array_equal(out, src.numpy())
    assert pool.made == [32 * KIB]               # 24 KiB, a power of two up


def _dense_roundtrip(a):
    return api.encode(a, device="cpu"), lambda e: api.decode(e, device="cpu")


def _wide_roundtrip(a):
    return (wide.encode_wide(a, device="cpu"),
            lambda e: wide.decode_wide(e, device="cpu"))


def _sharded_roundtrip(a):
    codec = ShardedCodec(make_mesh(devices=["cpu"] * 4))
    return codec.encode(a), codec.decode


ROUNDTRIPS = {"dense": _dense_roundtrip, "wide": _wide_roundtrip,
              "sharded": _sharded_roundtrip}


@pytest.mark.parametrize("hold", ["array", "u32_view"])
@pytest.mark.parametrize("path", ROUNDTRIPS)
def test_held_result_is_never_overwritten(pool, path, hold):
    a, b = _data(1, 96 * KIB + 12), _data(2, 96 * KIB + 12)
    enc_a, decode = ROUNDTRIPS[path](a)
    enc_b, _ = ROUNDTRIPS[path](b)     # enc_a's stream is held meanwhile
    kept = HOLD[hold](decode(enc_a))
    before = _counts()
    for _ in range(2):
        out_b = decode(enc_b)
        np.testing.assert_array_equal(out_b, b)
        np.testing.assert_array_equal(np.asarray(kept).view(np.uint8), a)
        del out_b
    # the second decode of b reused the first one's block, not a held one
    assert _change(before)["reused"] >= b.size
    np.testing.assert_array_equal(decode(enc_a), a)


def test_smallest_free_block_that_fits_is_taken(pool):
    held = [_copy(n) for n in (4 * KIB, 64 * KIB, 16 * KIB)]
    ptrs = [_ptr(h) for h in held]
    del held
    assert pool.made == [4 * KIB, 64 * KIB, 16 * KIB]
    mid = _copy(10 * KIB)
    assert _ptr(mid) == ptrs[2]
    small = _copy(MIN)
    assert _ptr(small) == ptrs[0]
    large = _copy(20 * KIB)                # the 16 KiB block is held
    assert _ptr(large) == ptrs[1]
    assert len(pool.made) == 3


def test_past_the_limit_a_copy_is_declined(pool):
    before, copied = _counts(), timing.copied["d2h.pageable"].n
    held = [_copy(300 * KIB) for _ in range(2)]    # 512 KiB blocks
    assert pool.pinned_bytes == LIMIT
    third = _copy(300 * KIB, fill=5)
    assert not any(np.shares_memory(third, b.numpy())
                   for b, _ in pool.blocks)
    assert (third == 5).all()
    assert _change(before) == {"reused": 0, "new": 600 * KIB,
                               "declined": 300 * KIB}
    assert timing.copied["d2h.pageable"].n - copied == 900 * KIB
    assert pool.pinned_bytes == LIMIT and len(pool.made) == 2
    del held
    before = _counts()
    _copy(300 * KIB)
    assert _change(before) == {"reused": 300 * KIB, "new": 0, "declined": 0}


def test_cpu_sources_and_small_copies_stay_out_of_the_pool(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA call or a block on the CPU path")

    monkeypatch.setattr(transfer, "host_pool",
                        transfer.HostPool(LIMIT, alloc=refuse))
    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)
    cuda = torch.device("cuda")
    assert transfer._host_block_path(cuda, transfer.PINNED_MIN_BYTES)
    assert not transfer._host_block_path(cuda, transfer.PINNED_MIN_BYTES - 1)
    assert not transfer._host_block_path(torch.device("cpu"), 1 << 40)
    assert transfer.host_block(torch.uint8, (1 << 30,), torch.device("cpu")) \
        is None
    before = _counts()
    big = torch.full((transfer.PINNED_MIN_BYTES + 4,), 3, dtype=torch.uint8)
    assert (transfer.to_host(big) == 3).all()
    mesh = make_mesh(devices=["cpu"] * 2)
    flat, _ = fetch(mesh, [big, big])
    assert flat.size == 2 * big.numel() and (flat == 3).all()
    a = _data(3, 64 * KIB)
    enc = api.encode(a, device="cpu")
    np.testing.assert_array_equal(api.decode(enc, device="cpu"), a)
    assert _change(before) == {"reused": 0, "new": 0, "declined": 0}


def _parts(dtype):
    rng = np.random.default_rng(4)
    sizes = (3000, 0, 1777, 4096)
    return [torch.from_numpy(rng.integers(0, 200, n).astype(dtype))
            for n in sizes]


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.uint32])
def test_fetch_fills_a_pooled_array_as_a_fresh_one(pool, monkeypatch, dtype):
    mesh = make_mesh(devices=["cpu"] * 4)
    parts = _parts(dtype)
    before = _counts()
    flat, offs = fetch(mesh, parts)
    nbytes = flat.nbytes
    assert _change(before) == {"reused": 0, "new": nbytes, "declined": 0}
    assert np.shares_memory(flat, pool.blocks[0][0].numpy())
    monkeypatch.setattr(transfer, "_host_block_path", lambda device, n: False)
    want, want_offs = fetch(mesh, parts)
    assert flat.dtype == want.dtype and flat.shape == want.shape
    np.testing.assert_array_equal(flat, want)
    np.testing.assert_array_equal(offs, want_offs)
    assert len(pool.made) == 1


def test_root_span_carries_the_pools_counts(pool):
    a = _data(5, 64 * KIB + 3)
    enc = api.encode(a, device="cpu")
    timing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        first = api.decode(enc, device="cpu")
        np.testing.assert_array_equal(first, a)
        del first
        np.testing.assert_array_equal(api.decode(enc, device="cpu"), a)
    roots = [r for r in timing.spans() if r.parent is None]
    timing.clear()
    assert [r.name for r in roots] == ["decode", "decode"]
    for r in roots:
        assert list(r.attrs["copied"]) == list(timing.COPY_KINDS)
        assert sum(r.attrs["copied"].values()) > a.size
    # the encode's stream is held by enc: the first decode makes a block
    assert [r.attrs["host_blocks"] for r in roots] == [
        {"reused": 0, "new": a.size, "declined": 0},
        {"reused": a.size, "new": 0, "declined": 0}]


def test_threads_never_share_a_held_block(pool):
    """Eight threads take, fill, check and drop blocks at a short switch
    interval: a block handed to two holders at once would mix fills."""
    errors, done = [], []

    def worker(tid: int):
        for i in range(150):
            out = _copy(MIN + 64 * (tid % 3), fill=tid)
            if not (out == tid).all():
                errors.append((tid, i))
            del out
        done.append(tid)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == list(range(8)) and errors == []
    assert pool.pinned_bytes <= LIMIT
