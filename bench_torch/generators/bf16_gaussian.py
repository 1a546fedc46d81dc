"""The bf16 Gaussian weight profile: the traffic file's `tensors`, in
order, each a matrix of normal weights with mean 0 and standard deviation
std / sqrt(std_divisor_sqrt), drawn as float32 on the device from a
torch.Generator seeded with the seed, rounded to bf16 (to nearest, ties to
even: torch's conversion), and returned as the bf16 words' little-endian
bytes, uint8.  At the traffic's own size the tensors have their shapes;
a smaller `bytes` (a test's) scales every tensor's element count alike,
so that each distribution keeps its share.  The same seed on the same
device gives the same bytes."""

from __future__ import annotations

import math

import torch

CHUNK = 64 << 20                  # elements drawn at a time


def std_of(tensor: dict) -> float:
    return tensor["std"] / math.sqrt(tensor.get("std_divisor_sqrt", 1))


def counts(traffic: dict) -> list[int]:
    """Each tensor's elements in `bytes` // 2 elements, in proportion to
    the tensors' shapes; the last takes what is left."""
    n = int(traffic["bytes"]) // 2
    sizes = [math.prod(t["shape"]) for t in traffic["tensors"]]
    total = sum(sizes)
    out = [size * n // total for size in sizes[:-1]]
    return out + [n - sum(out)]


def generate(traffic: dict, seed: int, device) -> torch.Tensor:
    if int(traffic["bytes"]) % 2:
        raise ValueError("a bf16 profile takes an even number of bytes")
    out = torch.empty(int(traffic["bytes"]), dtype=torch.uint8, device=device)
    words = out.view(torch.bfloat16)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    at = 0
    for tensor, size in zip(traffic["tensors"], counts(traffic)):
        std = std_of(tensor)
        for lo in range(0, size, CHUNK):
            k = min(CHUNK, size - lo)
            words[at + lo: at + lo + k] = (torch.randn(
                k, generator=g, dtype=torch.float32, device=device)
                * std).to(torch.bfloat16)
        at += size
    return out
