"""Device byte histogram (huffman_tpu/ops/histogram.py).

`histogram` counts on the tensor's device: the CUDA kernel
(csrc/histogram.cu, through ops/cuda/histogram.py) for a CUDA tensor, the
plain version below for a CPU one.  The JAX package's two formulations,
histogram_xla (a scatter-add) and histogram_onehot (nibble one-hots
contracted on the MXU), compute the same counts; both names are bound to
`histogram`.  The one-hot contraction itself is timed on the card as an
ablation (scripts/ablate_hist.py), not run here.
"""

from __future__ import annotations

import torch

from ..config import NUM_SYMBOLS
from . import Counter
from .cuda import histogram as k_hist

# calls on CUDA tensors; the main path makes none (it launches the kernel)
cuda_calls = Counter()

# 32-bit words are read as the little-endian bytes of the stream
WORD_DTYPES = (torch.int32, torch.uint32)


def histogram(data: torch.Tensor, n_valid: int | None = None) -> torch.Tensor:
    """256-bin int64 histogram of uint8 bytes, or of 32-bit words read as
    their little-endian bytes (byte 4j + k of the stream is bits
    [8k, 8k + 8) of word j), of any shape.  With n_valid, only the first
    n_valid BYTES in row-major order are counted (clamped to the buffer)."""
    if data.dtype in WORD_DTYPES:
        flat = data.reshape(-1).view(torch.uint8)
    elif data.dtype == torch.uint8:
        flat = data.reshape(-1)
    else:
        raise ValueError(f"histogram: want uint8 bytes or 32-bit words, "
                         f"got {data.dtype}")
    n = flat.numel() if n_valid is None else max(0, min(int(n_valid),
                                                        flat.numel()))
    return k_hist.histogram(flat, n)


def histogram_plain(data: torch.Tensor, n: int) -> torch.Tensor:
    """The plain version: a scatter-add of ones over data[:n] (what
    histogram_xla computes), data a 1-D uint8 tensor."""
    if data.is_cuda:
        cuda_calls.n += 1
    idx = data[:n].to(torch.int64)
    return torch.zeros(NUM_SYMBOLS, dtype=torch.int64,
                       device=data.device).scatter_add_(
                           0, idx, torch.ones_like(idx))


# the JAX package's names for its two formulations
histogram_xla = histogram
histogram_onehot = histogram
