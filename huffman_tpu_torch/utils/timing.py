"""Timing and profiling harness (huffman_tpu/utils/timing.py).

PyTorch launches return before the device finishes, so time_fn
synchronizes the device around every run, where the JAX package calls
jax.block_until_ready; on a CUDA device each run is timed with CUDA
events.  profiler_trace wraps torch.profiler.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable

import torch


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


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Optional torch.profiler trace of the host and, where there is one,
    the CUDA device, written to log_dir for TensorBoard or Perfetto."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


class HostTimer:
    """Host wall-clock timer: `with HostTimer() as t: ...; t.ms`."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = 1e3 * (time.perf_counter() - self.t0)
        return False
