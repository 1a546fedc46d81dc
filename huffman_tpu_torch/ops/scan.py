"""Exclusive scan of per-block bit counts (huffman_tpu/ops/scan.py).

`exclusive_bit_offsets` scans on the tensor's device: the CUDA kernel
(csrc/scan.cu, through ops/cuda/scan.py) for a CUDA tensor, the plain
version below for a CPU one.  The JAX package scans (full words,
remainder bits) separately to stay in int32; PyTorch has int64 on every
device, so the port scans bits in int64 and splits the result.  The wide
format's payload offsets (wide.payload_offsets) run through the same
kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import Counter
from .cuda import scan as k_scan

# calls on CUDA tensors; the main path makes none (it launches the kernel)
cuda_calls = Counter()


class BitOffsets(NamedTuple):
    """word_base[i] (int64): the word where block i's bits begin;
    bit_shift[i] (int32): its first bit within that word (0..31, from the
    MSB); total_bits (the end bit of the last block), total_words: 0-d
    int64 tensors."""
    word_base: torch.Tensor
    bit_shift: torch.Tensor
    total_bits: torch.Tensor
    total_words: torch.Tensor


def exclusive_bit_offsets(block_bits: torch.Tensor,
                          start_bit: int = 0) -> BitOffsets:
    """Offsets of blocks laid end to end from bit `start_bit` on (0..31: a
    shard of the sharded codec starts at its global bit phase)."""
    return k_scan.bit_offsets(block_bits, start_bit)


def exclusive_bit_offsets_plain(block_bits: torch.Tensor,
                                start_bit: int = 0) -> BitOffsets:
    """The plain version: an int64 cumsum, split into words and bits."""
    if block_bits.is_cuda:
        cuda_calls.n += 1
    bits = block_bits.to(torch.int64)
    ends = torch.cumsum(bits, 0) + start_bit
    starts = ends - bits
    total = ends[-1] if bits.numel() else torch.full(
        (), start_bit, dtype=torch.int64, device=bits.device)
    return BitOffsets(word_base=starts >> 5,
                      bit_shift=(starts & 31).to(torch.int32),
                      total_bits=total, total_words=(total + 31) >> 5)


def payload_offsets_plain(tile_words: torch.Tensor):
    """The plain version of the wide tiles' offsets: each tile's first
    payload word, the int64 exclusive sum of 2 * tile_words (its two
    planes), and the payload length as a 0-d int64 tensor."""
    if tile_words.is_cuda:
        cuda_calls.n += 1
    sizes = 2 * tile_words.to(torch.int64)
    ends = torch.cumsum(sizes, 0)
    total = ends[-1] if sizes.numel() else torch.zeros(
        (), dtype=torch.int64, device=sizes.device)
    return ends - sizes, total


def total_bits_host(offsets: BitOffsets) -> int:
    """The grand total of bits as a Python int (one host sync)."""
    return int(offsets.total_bits)


def block_bit_ends(lengths_per_symbol: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumsum of per-symbol code lengths along the last
    axis: each symbol's end bit within its block."""
    return torch.cumsum(lengths_per_symbol.to(torch.int32), dim=-1,
                        dtype=torch.int32)
