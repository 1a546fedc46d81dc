"""The plain version of DFloat11's byte planes of bf16 words: the split of
a bf16 tensor into its exponent bytes and its sign-mantissa bytes, and the
merge back (arXiv:2504.11651).  ops/cuda/planes.py launches the CUDA
kernels (csrc/planes.cu) for CUDA tensors and runs these for CPU ones.
The JAX package has no such stage: it codes opaque byte streams only.

For each bf16 word w (sign bit 15, exponent bits 14..7, mantissa 6..0):
  exponent byte       e = (w >> 7) & 0xFF
  sign-mantissa byte  s = ((w >> 8) & 0x80) | (w & 0x7F)
  merge               w = ((s & 0x80) << 8) | (e << 7) | (s & 0x7F)
Every bit pattern goes through unchanged, signed zeros, subnormals,
infinities and NaN payloads included.
"""

from __future__ import annotations

import torch

from . import Counter

# calls on CUDA tensors; the main path makes none (it launches the kernels)
cuda_calls = Counter()


def split_bf16_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(exponent, sign_mantissa): the (n,) uint8 planes of the 1-D bf16
    tensor x."""
    if x.is_cuda:
        cuda_calls.n += 1
    w = x.view(torch.int16).to(torch.int32) & 0xFFFF
    return (((w >> 7) & 0xFF).to(torch.uint8),
            (((w >> 8) & 0x80) | (w & 0x7F)).to(torch.uint8))


def merge_bf16_plain(exponent: torch.Tensor,
                     sign_mantissa: torch.Tensor) -> torch.Tensor:
    """The (n,) bf16 tensor whose planes are the (n,) uint8 tensors given."""
    if exponent.is_cuda:
        cuda_calls.n += 1
    e, s = exponent.to(torch.int32), sign_mantissa.to(torch.int32)
    w = ((s & 0x80) << 8) | (e << 7) | (s & 0x7F)
    return (w - (w >> 15 << 16)).to(torch.int16).view(torch.bfloat16)
