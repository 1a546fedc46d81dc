"""Timing and profiling (huffman_tpu/utils/timing.py), and the codec's own
spans and counters.

PyTorch launches return before the device finishes, so time_fn
synchronizes the device around every run, where the JAX package calls
jax.block_until_ready; on a CUDA device each run is timed with CUDA
events.

span(name, **attrs) marks a stage of a codec call.  It records only while
a torch.profiler session is active (an operator who profiles gets the
spans; nothing else does), and then on the profiler's clock,
time.time_ns(), so a span lines up with the device operations of the
same trace.  It never opens a profiler range, so it stays out of the
profiler's own event stream: a trace reader would take such a range's
device-side mirror for a kernel.  Outside a session span returns one
shared null context, at the cost of one attribute read.  spans() returns
the records, clear() empties them.

Counter is a count that a run resets and reads: kernel launches, calls of
a plain version on CUDA tensors (ops/), and `copied`, the bytes that
cross between host and device by direction and host memory kind
("h2d.pageable", "h2d.pinned", "d2h.pageable", "d2h.pinned";
transfer.to_device and transfer.to_host count them), and `host_blocks`,
the bytes of the copies that asked transfer.host_pool for a pinned host
block, by what they got ("reused", "new", "declined": left to pageable
memory), and
`container_bytes`, the payload bytes that the host container swapped,
copied or checksummed, by where: "pieces" on its worker threads, "whole"
on the calling thread.  A root span (one with no open parent in its
thread) stores each count's change over its life as its attribute of the
same name: "copied", "host_blocks", "container_bytes".
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Callable

import torch
import torch.autograd.profiler as _profiler


class Counter:
    """A count that a run resets and reads: kernel launches, calls of a
    plain version on CUDA tensors (which the main path never makes), or
    bytes copied."""

    def __init__(self) -> None:
        self.n = 0


COPY_KINDS = ("h2d.pageable", "h2d.pinned", "d2h.pageable", "d2h.pinned")
copied = {kind: Counter() for kind in COPY_KINDS}
HOST_BLOCK_KINDS = ("reused", "new", "declined")
host_blocks = {kind: Counter() for kind in HOST_BLOCK_KINDS}
CONTAINER_KINDS = ("pieces", "whole")
container_bytes = {kind: Counter() for kind in CONTAINER_KINDS}
_ROOT_COUNTS = {"copied": copied, "host_blocks": host_blocks,
                "container_bytes": container_bytes}


class Span:
    """One recorded span: `parent` is the index in spans() of the span that
    was open around it in its thread (None for a root), `call` the call id
    that a root draws and its descendants share; times are time.time_ns()."""
    __slots__ = ("name", "parent", "call", "start_ns", "end_ns", "attrs")

    def __init__(self, name, parent, call, start_ns, attrs):
        self.name, self.parent, self.call = name, parent, call
        self.start_ns, self.end_ns, self.attrs = start_ns, None, attrs

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, parent={self.parent}, call={self.call}, "
                f"{self.start_ns}..{self.end_ns}, {self.attrs})")


_records: list[Span] = []
_local = threading.local()
_calls = itertools.count()
_NULL = contextlib.nullcontext()


class _Recording:
    __slots__ = ("rec", "before")

    def __init__(self, name: str, attrs: dict):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            parent = stack[-1]
            call = _records[parent].call
            self.before = None
        else:
            parent, call = None, next(_calls)
            self.before = {name: {k: c.n for k, c in counts.items()}
                           for name, counts in _ROOT_COUNTS.items()}
        self.rec = Span(name, parent, call, None, attrs)

    def __enter__(self):
        _local.stack.append(len(_records))
        _records.append(self.rec)
        self.rec.start_ns = time.time_ns()
        return self.rec

    def __exit__(self, *exc):
        self.rec.end_ns = time.time_ns()
        _local.stack.pop()
        if self.before is not None:
            for name, counts in _ROOT_COUNTS.items():
                self.rec.attrs[name] = {k: c.n - self.before[name][k]
                                        for k, c in counts.items()}
        return False


def span(name: str, **attrs):
    """A context that records a span `name` with `attrs` while a
    torch.profiler session is active, and the shared null context
    otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Recording(name, attrs)


def spans() -> list[Span]:
    """The recorded spans, in the order they opened."""
    return list(_records)


def clear() -> None:
    """Forget the recorded spans (between calls, with no span open)."""
    _records.clear()


def time_fn(fn: Callable[[], Any], iters: int = 10, warmup: int = 2,
            device="cuda") -> dict:
    """Wall time of fn over `iters` runs after `warmup` runs, with the
    device synchronized before and after each run: CUDA events on a CUDA
    device, perf_counter on the CPU."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn()
        sync()
    times = []
    for _ in range(iters):
        sync()
        if cuda:
            with torch.cuda.device(device):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "mean_ms": 1e3 * sum(times) / len(times),
        "min_ms": 1e3 * times[0],
        "median_ms": 1e3 * times[len(times) // 2],
        "iters": iters,
    }


class HostTimer:
    """Host wall-clock timer: `with HostTimer() as t: ...; t.ms`."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = 1e3 * (time.perf_counter() - self.t0)
        return False
