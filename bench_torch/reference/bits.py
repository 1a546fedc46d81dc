"""Plain PyTorch bit placement and reading, shared by the reference codecs.

Words are 32-bit values held in int64 tensors, bits MSB-first.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def place(code: torch.Tensor, length: torch.Tensor, pos: torch.Tensor):
    """Where each code lands: its first word index (pos >> 5) and its bits
    in that word and the next (hi, lo), for codes of at most 32 bits at
    bit positions pos (all int64).  A zero length gives zero bits."""
    shift = pos & 31
    end = shift + length                       # within the word pair
    one = end <= 32
    hi = torch.where(one, code << (32 - end).clamp(min=0),
                     code >> (end - 32).clamp(min=0))
    lo = torch.where(one, torch.zeros_like(code),
                     (code << (64 - end).clamp(max=63)) & MASK32)
    return pos >> 5, hi, lo


def scatter_words(out: torch.Tensor, word: torch.Tensor, hi: torch.Tensor,
                  lo: torch.Tensor) -> None:
    """OR (hi, lo) into out[word], out[word + 1]: the bits of different
    codes never overlap, so a sum is their OR."""
    out.index_add_(0, word, hi)
    out.index_add_(0, word + 1, lo)


def window(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The 32 bits that start at bit pos of words (int64 values < 2**32,
    read as zero past the end)."""
    last = words.numel() - 1
    w = pos >> 5
    sh = pos & 31
    a = words[w.clamp(max=last)] * (w <= last)
    b = words[(w + 1).clamp(max=last)] * (w + 1 <= last)
    return ((a << sh) | (b >> (32 - sh))) & MASK32


def byteswap32(words: torch.Tensor) -> torch.Tensor:
    """int64 values < 2**32 with their four bytes reversed."""
    return (((words & 0xFF) << 24) | ((words & 0xFF00) << 8)
            | ((words >> 8) & 0xFF00) | ((words >> 24) & 0xFF))
