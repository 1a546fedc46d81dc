"""Device byte histogram (huffman_tpu/ops/histogram.py).

The JAX histogram is XLA (a one-hot matmul), not a Pallas kernel, so the
port counts with torch.bincount on whatever device holds the bytes.
"""

from __future__ import annotations

import torch

from ..config import NUM_SYMBOLS


def histogram(data: torch.Tensor, n_valid: int | None = None) -> torch.Tensor:
    """256-bin int64 histogram of a uint8 tensor (any shape); with n_valid,
    only the first n_valid bytes in row-major order are counted."""
    flat = data.reshape(-1)
    if n_valid is not None:
        flat = flat[:n_valid]
    return torch.bincount(flat, minlength=NUM_SYMBOLS)
