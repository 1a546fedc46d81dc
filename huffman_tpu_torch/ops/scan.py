"""Exclusive scan of per-block bit counts (huffman_tpu/ops/scan.py).

The JAX package scans (full words, remainder bits) separately to stay in
int32; PyTorch has int64 on every device, so the port scans bits in int64
and splits the result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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
    """Offsets of blocks laid end to end from bit `start_bit` on (a shard
    of the sharded codec starts at its global bit phase, 0..31)."""
    bits = block_bits.to(torch.int64)
    ends = torch.cumsum(bits, 0) + start_bit
    starts = ends - bits
    total = ends[-1] if bits.numel() else torch.full(
        (), start_bit, dtype=torch.int64, device=bits.device)
    return BitOffsets(word_base=starts >> 5,
                      bit_shift=(starts & 31).to(torch.int32),
                      total_bits=total, total_words=(total + 31) >> 5)


def total_bits_host(offsets: BitOffsets) -> int:
    """The grand total of bits as a Python int (one host sync)."""
    return int(offsets.total_bits)


def block_bit_ends(lengths_per_symbol: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumsum of per-symbol code lengths along the last
    axis: each symbol's end bit within its block."""
    return torch.cumsum(lengths_per_symbol.to(torch.int32), dim=-1,
                        dtype=torch.int32)
