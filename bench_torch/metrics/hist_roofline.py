"""The byte histogram (ops/cuda/histogram, csrc/histogram.cu) against its
bandwidth bound: each launch reads the bytes it counts once and writes
its 256 int64 bins once.  The dense driver counts its sample (every 16th
block) and, after a miss, the whole input; every other path the whole
input (a sharded one, each shard its part)."""

from bench_torch.peaks import roofline

KERNELS = r"\bhistogram_kernel\b"
BINS = 256 * 8


def bytes_of(rt, work) -> int:
    info = rt["info"]
    counted = work["sample_bytes"] if info.get("sampled") else 0
    if not info.get("sampled") or info.get("rebuilt"):
        counted += rt["n"]
    return counted + BINS * info["launches"]["histogram"]


def read(run):
    return roofline(run, KERNELS, bytes_of)
