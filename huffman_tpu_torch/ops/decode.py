"""Plain PyTorch version of the dense decoder (K4).

Computes what huffman_tpu/ops/decode.py decode_blocks and the Pallas
kernel huffman_tpu/ops/pallas/dense_decode.py decode_dense compute: every
block decoded from its own bit offset with a single-level lookup table,
one lane per block, written block-major.  The CUDA kernel
(csrc/dense_decode.cu) is held to it bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import Counter, bitio

cuda_calls = Counter()


def table_entries(codebook, table_bits: int) -> np.ndarray:
    """(2**table_bits,) int16 lookup table: entry = (symbol << 8) | length,
    where length 0 marks a value no code prefixes."""
    syms, lens = codebook.decode_table(table_bits)
    return ((syms.astype(np.uint16) << 8) | lens).view(np.int16)


def decode_blocks(stream: torch.Tensor, word_base: torch.Tensor,
                  bit_shift: torch.Tensor, valid_bytes: torch.Tensor,
                  table: torch.Tensor, table_bits: int,
                  block_bytes: int) -> torch.Tensor:
    """Decode every block of a dense stream.

    Args:
      stream: (NW,) int32 stream words; reads past the end see zeros.
      word_base: (NB,) int64, bit_shift: (NB,) int32 block start cursors.
      valid_bytes: (NB,) int32 bytes to decode in each block.
      table: (2**table_bits,) int16 entries from table_entries().
      table_bits: table width, >= the codebook's longest code.
      block_bytes: bytes per full block.

    Returns (NB, block_bytes) uint8, zero past each block's valid bytes.
    """
    if stream.is_cuda:
        cuda_calls.n += 1
    dev = stream.device
    s = torch.cat([bitio.to_u32(stream),
                   torch.zeros(2, dtype=torch.int64, device=dev)])
    last = s.numel() - 1
    tab = table.to(torch.int64) & 0xFFFF
    syms, lens = tab >> 8, tab & 0xFF
    wp = word_base.to(torch.int64).clone()
    bp = bit_shift.to(torch.int64)
    valid = valid_bytes.to(torch.int64)
    out = torch.zeros(block_bytes, word_base.numel(), dtype=torch.uint8,
                      device=dev)
    for i in range(block_bytes):
        w0 = s[wp.clamp(max=last)]
        w1 = s[(wp + 1).clamp(max=last)]
        idx = bitio.extract_window(w0, w1, bp) >> (32 - table_bits)
        active = i < valid
        out[i] = torch.where(active, syms[idx], 0).to(torch.uint8)
        bp = bp + torch.where(active, lens[idx], 0)
        wp = wp + (bp >> 5)
        bp = bp & 31
    return out.T.contiguous()
