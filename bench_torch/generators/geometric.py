"""The geometric byte profile: bytes 0 .. symbols - 1 drawn i.i.d. with
probability proportional to decay ** i, the decay bisected until the
distribution's entropy is the traffic file's `entropy_bits_per_byte`
(the arithmetic of the project's utils/testdata.py, copied).  The draw is
float64 uniforms on the device, a torch.Generator seeded with the seed,
mapped through the inverse CDF: the same seed on the same device gives
the same bytes."""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 64 << 20


def geometric_probs(symbols: int, decay: float) -> np.ndarray:
    p = decay ** np.arange(symbols, dtype=np.float64)
    return p / p.sum()


def entropy(p: np.ndarray) -> float:
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def decay_for_entropy(target: float, symbols: int) -> float:
    lo, hi = 1e-6, 1.0 - 1e-9
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if entropy(geometric_probs(symbols, mid)) < target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def probabilities(traffic: dict) -> np.ndarray:
    symbols = traffic["symbols"]
    return geometric_probs(symbols, decay_for_entropy(
        traffic["entropy_bits_per_byte"], symbols))


def generate(traffic: dict, seed: int, device) -> torch.Tensor:
    p = probabilities(traffic)
    cdf = torch.tensor(np.cumsum(p), dtype=torch.float64, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n = int(traffic["bytes"])
    out = torch.empty(n, dtype=torch.uint8, device=device)
    for lo in range(0, n, CHUNK):
        u = torch.rand(min(CHUNK, n - lo), generator=g, dtype=torch.float64,
                       device=device)
        out[lo: lo + u.numel()] = torch.searchsorted(
            cdf, u, right=True).clamp_(max=p.size - 1).to(torch.uint8)
    return out
