"""Host-device copies: the layer under the codec's entry points.

Every host-device copy of the codec goes through to_device and to_host,
which count its bytes by direction and host memory kind (pinned or
pageable) in utils/timing.copied.  A copy of PINNED_MIN_BYTES or more from
a CUDA device lands in a pinned host block that host_pool keeps from call
to call (HostPool).  device_rows puts a host byte stream on a device as
zero-padded rows, and stage_chunks does so chunk by chunk through a ring
of PINNED_RING pinned buffers on a side stream.

It imports nothing of the modules above it (api, wide, container,
parallel): they import it.
"""

from __future__ import annotations

import threading
import warnings
import weakref

import numpy as np
import torch

from .utils import timing
from .utils.timing import span

# Pinned host buffers of the staging ring: the host fills one while the
# other's copy runs.  They come from PyTorch's caching host allocator,
# which keeps freed pinned blocks for the next call, so the ring is not
# cached here.
PINNED_RING = 2
# A device-to-host copy of PINNED_MIN_BYTES (one staging chunk) or more
# lands in a pinned host block that host_pool keeps from call to call;
# smaller ones (bit counts, histograms, totals) go to fresh pageable
# memory.  The pool pins at most PINNED_POOL_BYTES: the blocks of a 1 GiB
# roundtrip (its 1 GiB output, its stream's 512 MiB) and of a caller that
# holds two more outputs, so that a caller that keeps every result pins
# no more of the host's memory than that, and copies as before past it.
PINNED_MIN_BYTES = 16 * 1024 * 1024
PINNED_POOL_BYTES = 4 * 1024**3


def _host_tensor(arr) -> torch.Tensor:
    """A CPU tensor over a host array's memory, no copy made.  Read-only
    arrays (views of bytes objects) are fine: the tensor is only read."""
    if isinstance(arr, torch.Tensor):
        return arr
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.asarray(arr))


def _count(kind: str, host: torch.Tensor, nbytes: int) -> None:
    memory = "pinned" if host.is_pinned() else "pageable"
    timing.copied[f"{kind}.{memory}"].n += nbytes


def _pinned(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


class HostPool:
    """Host blocks that large device-to-host copies land in, kept from
    call to call: a fresh pageable destination faults in its pages at
    every call, and the CUDA driver stages a copy to pageable memory
    through buffers of its own besides.

    take(dtype, shape) hands out a host array over the smallest free block
    that fits, or over a new one while the blocks stay within `limit`
    bytes, and otherwise returns None: the caller then copies as before.
    A block is free again once no array over it is left: each view of the
    array handed out refers to that array (numpy makes a view's base the
    first array up the chain whose base is no array, here a tensor), so
    the pool's weak reference to it dies with the last of them.  A block
    held is never handed out.  Blocks are kept for the process's life;
    PyTorch's caching host allocator rounds a pinned request up to a
    power of two, so a block is taken at that size.  `alloc(nbytes)` makes
    a block (_pinned; the CPU tests pass a plain one).  The bytes asked
    for are counted in timing.host_blocks as reused, new or declined."""

    def __init__(self, limit: int, alloc=_pinned):
        self.limit, self.alloc = limit, alloc
        self.blocks: list[list] = []        # [block, weakref to its array]
        self._lock = threading.Lock()

    @property
    def pinned_bytes(self) -> int:
        return sum(block.numel() for block, _ in self.blocks)

    def take(self, dtype: torch.dtype, shape: tuple
             ) -> tuple[torch.Tensor, np.ndarray] | None:
        """(a tensor, the host array) of `shape` and `dtype` over one
        block, or None."""
        nbytes = int(np.prod(shape)) * dtype.itemsize
        size = 1 << (nbytes - 1).bit_length()
        with self._lock:
            free = [e for e in self.blocks
                    if e[0].numel() >= nbytes and e[1]() is None]
            if free:
                entry = min(free, key=lambda e: e[0].numel())
                kind = "reused"
            elif self.pinned_bytes + size <= self.limit:
                entry, kind = [self.alloc(size), None], "new"
                self.blocks.append(entry)
            else:
                timing.host_blocks["declined"].n += nbytes
                return None
            timing.host_blocks[kind].n += nbytes
            dst = entry[0][:nbytes].view(dtype).view(shape)
            arr = dst.numpy()
            entry[1] = weakref.ref(arr)
            return dst, arr


host_pool = HostPool(PINNED_POOL_BYTES)


def _host_block_path(device: torch.device, nbytes: int) -> bool:
    """Whether a device-to-host copy of nbytes from `device` asks host_pool
    for a block: from a CUDA device, PINNED_MIN_BYTES or more.  The CPU
    tests patch it."""
    return device.type == "cuda" and nbytes >= PINNED_MIN_BYTES


def host_block(dtype: torch.dtype, shape: tuple, device: torch.device
               ) -> tuple[torch.Tensor, np.ndarray] | None:
    """host_pool.take(dtype, shape) for a copy from `device` that
    _host_block_path admits, else None."""
    nbytes = int(np.prod(shape)) * dtype.itemsize
    if not _host_block_path(device, nbytes):
        return None
    return host_pool.take(dtype, shape)


def to_device(src, device=None, out: torch.Tensor | None = None,
              non_blocking: bool = False) -> torch.Tensor:
    """Copy a host array or CPU tensor to `device`, or into the tensor
    `out`, and return the copy; every host-to-device copy of the codec
    goes through here, its bytes counted in timing.copied by the host
    memory's kind (pinned or pageable).  The count is made whatever the
    device: on the CPU the copy is the codec's host/device boundary all
    the same."""
    host = _host_tensor(src)
    _count("h2d", host, host.numel() * host.element_size())
    if out is None:
        return host.to(device, non_blocking=non_blocking)
    return out.copy_(host, non_blocking=non_blocking)


def to_host(src: torch.Tensor, out=None) -> np.ndarray:
    """Copy a device tensor to host memory, into the host array or CPU
    tensor `out` where given, and return the host array; every
    device-to-host copy of the codec goes through here, counted as
    to_device's are.  Without `out`, a large copy from a CUDA device lands
    in a block of host_pool (host_block), any other in fresh memory."""
    if out is None:
        pooled = host_block(src.dtype, tuple(src.shape), src.device)
        if pooled is None:
            host = src.cpu()
            _count("d2h", host, host.numel() * host.element_size())
            return host.numpy()
        dst, arr = pooled
        _count("d2h", dst, dst.numel() * dst.element_size())
        dst.copy_(src)
        return arr
    dst = _host_tensor(out)
    _count("d2h", dst, src.numel() * src.element_size())
    dst.copy_(src)
    return dst.numpy()


def valid_on(n_bytes: int, num_rows: int, row_bytes: int,
             device: torch.device) -> torch.Tensor:
    """(num_rows,) int32 real byte count of each row of n_bytes cut into
    rows of row_bytes: row_bytes for full rows, the remainder for a final
    partial one, 0 past it.  Made on `device`: nothing crosses."""
    starts = torch.arange(num_rows, dtype=torch.int64,
                          device=device) * row_bytes
    return (n_bytes - starts).clamp_(0, row_bytes).to(torch.int32)


def device_rows(arr: np.ndarray, n_rows: int, row_bytes: int,
                device: torch.device):
    """(n_rows, row_bytes) uint8 rows of `arr` on `device`, zero past it
    (arr holds at most n_rows * row_bytes bytes), and the (n_rows,) int32
    valid byte counts (valid_on).  The input goes to the device as it is:
    no padded copy is made on the host."""
    n = arr.size
    rows = torch.empty(n_rows * row_bytes, dtype=torch.uint8, device=device)
    to_device(arr, out=rows[:n])
    rows[n:].zero_()
    return rows.view(n_rows, row_bytes), valid_on(n, n_rows, row_bytes,
                                                  device)


def stage_chunks(arr: np.ndarray, rows: torch.Tensor, chunk_bytes: int):
    """Copy arr into the flat uint8 buffer `rows` (zero past arr),
    chunk_bytes at a time, yielding each chunk's range [lo, hi) of rows
    once the current stream may read it.

    On a CUDA device each chunk goes through one of PINNED_RING pinned
    host buffers and is copied on a side stream: the caller's work on
    chunk i, enqueued on the current stream behind an event, overlaps the
    host's copy of chunk i + 1 into the next buffer and that buffer's
    copy to the device.  A buffer is refilled only once its last copy has
    completed.  On the CPU the copies are plain, and no CUDA call is made.
    Each chunk's host work runs in a span encode.stage.
    """
    n, total = arr.size, rows.numel()
    spans = [(lo, min(lo + chunk_bytes, total))
             for lo in range(0, total, chunk_bytes)]
    if rows.device.type != "cuda":
        for lo, hi in spans:
            with span("encode.stage"):
                if lo < n:
                    to_device(arr[lo: min(hi, n)], out=rows[lo: min(hi, n)])
                rows[max(lo, n): hi].zero_()
            yield lo, hi
        return
    compute = torch.cuda.current_stream(rows.device)
    side = torch.cuda.Stream(rows.device)
    side.wait_stream(compute)           # rows was allocated on `compute`
    rows.record_stream(side)            # and is written on `side`
    ring = [torch.empty(chunk_bytes, dtype=torch.uint8, pin_memory=True)
            for _ in range(PINNED_RING)]
    copied = [None] * PINNED_RING
    for i, (lo, hi) in enumerate(spans):
        slot = i % PINNED_RING
        with span("encode.stage"):
            if copied[slot] is not None:
                copied[slot].synchronize()
            with torch.cuda.stream(side):
                if lo < n:
                    buf = ring[slot][: min(hi, n) - lo]
                    buf.copy_(_host_tensor(arr[lo: min(hi, n)]))
                    to_device(buf, out=rows[lo: min(hi, n)],
                              non_blocking=True)
                rows[max(lo, n): hi].zero_()
                copied[slot] = torch.cuda.Event()
                copied[slot].record(side)
            compute.wait_event(copied[slot])
        yield lo, hi
