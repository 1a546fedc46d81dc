"""Plain PyTorch version of the dense pack (K2 preshift + K3 tile pack).

Computes what huffman_tpu/ops/pack.py pack_at_offsets and the Pallas pair
huffman_tpu/ops/pallas/pack2.py preshift_rows_pallas + pack_tiles_pallas
compute: every block stream shifted to its global bit phase and written at
its word offset, seam words ORed.  The CUDA kernel (csrc/pack.cu) is held
to it bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import Counter, bitio

cuda_calls = Counter()


def pack_blocks(streams: torch.Tensor, block_bits: torch.Tensor,
                word_base: torch.Tensor, bit_shift: torch.Tensor,
                n_words: int) -> torch.Tensor:
    """Stitch per-block streams into one dense stream.

    Args:
      streams: (NB, CAP) int32 block streams (bit 0 at the MSB of word 0,
        zero past each block's bits).
      block_bits: (NB,) int32 bits per block (flags masked off).
      word_base: (NB,) int64, bit_shift: (NB,) int32 exclusive offsets
        (ops.scan.exclusive_bit_offsets).
      n_words: output length, ceil(total_bits / 32).

    Returns (n_words,) int32 stream words.
    """
    if streams.is_cuda:
        cuda_calls.n += 1
    nb, cap = streams.shape
    x = bitio.to_u32(streams)
    # words past a block's bits are zero, except in a block that overflowed
    # its capacity: keep only its live words, as the kernel does
    live_words = (block_bits.to(torch.int64)[:, None] + 31) >> 5
    x = torch.where(torch.arange(cap, device=x.device)[None, :] < live_words,
                    x, 0)
    s = bit_shift.to(torch.int64)[:, None]
    prev = torch.nn.functional.pad(x, (1, 0))[:, :-1]
    body = bitio.shift_word_stream(x, prev, s)
    spill = bitio.shift_word_stream(torch.zeros_like(x[:, -1:]), x[:, -1:], s)
    contrib = torch.cat([body, spill], dim=1)              # (NB, CAP + 1)
    dest = word_base.to(torch.int64)[:, None] + torch.arange(
        cap + 1, device=x.device)
    # seam words carry disjoint bits, so add == or; slot n_words drops the
    # zero words past the end of the stream
    out = torch.zeros(n_words + 1, dtype=torch.int64, device=x.device)
    out.index_add_(0, dest.clamp(max=n_words).reshape(-1), contrib.reshape(-1))
    return bitio.to_i32(out[:n_words])


def pack_reference(packed_blocks, block_bits) -> tuple:
    """Numpy twin of the pack, a word at a time (slow, for tests): the
    (NB * CAP + 1,) uint32 dense stream of the (NB, CAP) block streams, and
    the total bits."""
    import numpy as np
    nb, cap = packed_blocks.shape
    x = np.asarray(packed_blocks).astype(np.uint32).astype(np.uint64)
    bits = np.asarray(block_bits, dtype=np.int64)
    out = np.zeros(nb * cap + 1, dtype=np.uint64)
    cursor = 0
    for b in range(nb):
        base, sh = cursor >> 5, cursor & 31
        for j in range((int(bits[b]) + 31) // 32):
            v = int(x[b, j]) << (32 - sh)
            out[base + j] |= (v >> 32) & 0xFFFFFFFF
            out[base + j + 1] |= v & 0xFFFFFFFF
        cursor += int(bits[b])
    return out.astype(np.uint32), int(bits.sum())
