"""Bit-level helpers for the plain PyTorch versions (huffman_tpu/ops/bitio.py).

PyTorch's uint32 is a storage type: shifts and index_add_ are not
implemented for it.  So the plain versions hold 32-bit stream words as
int64 values in [0, 2**32), where every shift below stays clear of the
sign bit, and store them as int32 bit patterns (`to_i32` / `to_u32`).
Shifts by 32 or more are undefined on the card; these helpers define them
as 0, as the JAX package does.

Bitstream convention: bit i of the stream is bit (31 - (i & 31)) of word
(i >> 5), i.e. MSB-first words.
"""

from __future__ import annotations

import torch

WORD_BITS = 32
M32 = 0xFFFFFFFF


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return x.to(torch.int64) & M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def safe_shl(x: torch.Tensor, n) -> torch.Tensor:
    """(x << n) & M32 for x < 2**32, and 0 where n >= 32 or n < 0."""
    n = torch.as_tensor(n, dtype=torch.int64, device=x.device)
    shifted = (x << n.clamp(0, WORD_BITS - 1)) & M32
    return torch.where((n >= WORD_BITS) | (n < 0), 0, shifted)


def safe_shr(x: torch.Tensor, n) -> torch.Tensor:
    """x >> n for x < 2**32, and 0 where n >= 32 or n < 0."""
    n = torch.as_tensor(n, dtype=torch.int64, device=x.device)
    shifted = x >> n.clamp(0, WORD_BITS - 1)
    return torch.where((n >= WORD_BITS) | (n < 0), 0, shifted)


def code_word_parts(code: torch.Tensor, length: torch.Tensor,
                    bit_offset: torch.Tensor):
    """OR-contributions (part0, part1) of a right-aligned code of `length`
    (<= 24) bits placed at `bit_offset` (0..31) of a word and the next."""
    end = bit_offset + length
    code = torch.where(length > 0, code, 0)
    fits = end <= WORD_BITS
    part0 = torch.where(fits, safe_shl(code, WORD_BITS - end),
                        safe_shr(code, end - WORD_BITS))
    part1 = torch.where(fits, 0, safe_shl(code, 2 * WORD_BITS - end))
    return part0, part1


def shift_word_stream(words: torch.Tensor, prev_words: torch.Tensor,
                      shift: torch.Tensor) -> torch.Tensor:
    """Shift a word stream right by `shift` (0..31) bits:
    out[j] = (words[j] >> shift) | (prev_words[j] << (32 - shift))."""
    return safe_shr(words, shift) | safe_shl(prev_words, WORD_BITS - shift)


def extract_window(w0: torch.Tensor, w1: torch.Tensor,
                   bitpos: torch.Tensor) -> torch.Tensor:
    """The 32 stream bits starting at bit `bitpos` (0..31) of word w0."""
    return safe_shl(w0, bitpos) | safe_shr(w1, WORD_BITS - bitpos)
