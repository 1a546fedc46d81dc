"""Traffic's input bytes: the traffic file (traffic/<name>.json) names its
byte profile, `profile`, and the generator generators/<profile>.py draws
traffic["bytes"] bytes of it on the device from the run's seed."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def generator(profile: str):
    path = HERE / "generators" / f"{profile}.py"
    if not path.is_file():
        raise ValueError(f"no generator for the traffic profile {profile!r}")
    spec = importlib.util.spec_from_file_location(
        "bench_torch.generators." + profile.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generate(traffic: dict, seed: int, device) -> torch.Tensor:
    """traffic["bytes"] uint8 bytes on `device`."""
    return generator(traffic["profile"]).generate(traffic, seed, device)


def describe(x: torch.Tensor) -> dict:
    """The drawn bytes' measured entropy and distinct-symbol count."""
    counts = torch.bincount(x, minlength=256).cpu().numpy()
    p = counts[counts > 0] / max(counts.sum(), 1)
    return {"bytes": int(x.numel()),
            "entropy_bits_per_byte": float(-(p * np.log2(p)).sum()),
            "distinct_symbols": int(np.count_nonzero(counts))}
