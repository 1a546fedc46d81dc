"""Device probing and error surfaces (huffman_tpu/utils/device.py).

The port's devices are torch's: every CUDA device of this process, and
the CPU, where the kernel wrappers run their plain versions.  A probe for
CUDA devices that finds none raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


class DeviceError(RuntimeError):
    pass


def probe_devices(platform: str = "cuda") -> list[torch.device]:
    """The usable devices of `platform` ("cuda" or "cpu"): every CUDA
    device of this process, or the one CPU device.  Raises DeviceError if
    there is none."""
    if platform == "cpu":
        return [torch.device("cpu")]
    if platform != "cuda":
        raise DeviceError(f"unknown device type {platform!r} (cuda or cpu)")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise DeviceError("no cuda devices found (torch "
                          f"{torch.__version__}, CUDA {torch.version.cuda})")
    return [torch.device("cuda", i) for i in range(n)]


def process_rank() -> int:
    """This process's rank in the torch.distributed group, 0 without one."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def describe_devices() -> str:
    """One line per device: every CUDA device (name, compute capability,
    memory, process rank), then the CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    rank = process_rank()
    lines = [f"{n} cuda device(s), torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}"]
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        lines.append(f"  [cuda:{i}] {p.name}, compute capability "
                     f"{p.major}.{p.minor}, {p.total_memory / 2**30:.1f} GiB "
                     f"(process {rank})")
    lines.append(f"  [cpu] {torch.get_num_threads()} threads "
                 f"(process {rank})")
    return "\n".join(lines)


def device_memory_stats() -> dict:
    """torch.cuda.memory_stats of every CUDA device, by index."""
    return {d.index: torch.cuda.memory_stats(d)
            for d in probe_devices("cuda")}
