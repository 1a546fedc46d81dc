"""Plain PyTorch version of the block encoder (K1).

Computes what huffman_tpu/ops/encode.py encode_blocks and the Pallas
kernel huffman_tpu/ops/pallas/encode.py encode_blocks_pallas compute; the
CUDA kernel (csrc/encode.cu) is held to it bit for bit.
"""

from __future__ import annotations

import torch

from . import Counter, bitio

# bit 31 of a block's bit count flags a valid byte with no code
MISS_FLAG = 1 << 31
BITS_MASK = MISS_FLAG - 1

# calls on CUDA tensors; the main path makes none (it launches the kernel)
cuda_calls = Counter()


def encode_blocks(byte_blocks: torch.Tensor, codes: torch.Tensor,
                  lengths: torch.Tensor, valid_bytes: torch.Tensor,
                  capacity_words: int):
    """Encode independent blocks of bytes into per-block bitstreams.

    Args:
      byte_blocks: (NB, BB) uint8, one row per block.
      codes: (256,) int32 right-aligned codeword values.
      lengths: (256,) int32 codeword lengths (0 = absent), <= 24.
      valid_bytes: (NB,) int32 real byte count of each block.
      capacity_words: words kept per block; bits past capacity_words * 32
        are dropped while the count stays exact.

    Returns:
      streams: (NB, capacity_words) int32 words, each block's codes
        concatenated MSB-first from bit 0 of word 0, zero past its bits.
      block_bits: (NB,) int32 exact bit count, with MISS_FLAG set where a
        valid byte has no code.
    """
    if byte_blocks.is_cuda:
        cuda_calls.n += 1
    return encode_rows(byte_blocks, codes, lengths, valid_bytes,
                       capacity_words)


def overflowed(block_bits: torch.Tensor, capacity_words: int) -> torch.Tensor:
    """0-d bool tensor: whether any block needs more than capacity_words
    words (block_bits with flags masked off)."""
    return torch.any(block_bits > capacity_words * 32)


def encode_rows(byte_blocks: torch.Tensor, codes: torch.Tensor,
                lengths: torch.Tensor, valid_bytes: torch.Tensor,
                capacity_words: int):
    """encode_blocks without its count: the body that the plain substream
    encoder (ops/wide.py) shares."""
    nb, bb = byte_blocks.shape
    cap = capacity_words
    sym = byte_blocks.to(torch.int64)
    L = lengths.to(torch.int64)[sym]
    pos = torch.arange(bb, device=sym.device)[None, :]
    live = pos < valid_bytes.to(torch.int64)[:, None]
    missing = (live & (L == 0)).any(dim=1)
    L = torch.where(live, L, 0)
    C = bitio.to_u32(codes)[sym]

    ends = torch.cumsum(L, dim=1)
    off = ends - L
    part0, part1 = bitio.code_word_parts(C, L, off & 31)
    d0 = off >> 5
    # Disjoint bit ranges make add == or.  Column `cap` is a drop slot for
    # words past the capacity.
    rows = torch.arange(nb, device=sym.device)[:, None] * (cap + 1)
    out = torch.zeros(nb * (cap + 1), dtype=torch.int64, device=sym.device)
    out.index_add_(0, (rows + d0.clamp(max=cap)).reshape(-1), part0.reshape(-1))
    out.index_add_(0, (rows + (d0 + 1).clamp(max=cap)).reshape(-1),
                   part1.reshape(-1))
    streams = bitio.to_i32(out.view(nb, cap + 1)[:, :cap])
    bits = ends[:, -1] | (missing.to(torch.int64) << 31)
    return streams, bitio.to_i32(bits)
