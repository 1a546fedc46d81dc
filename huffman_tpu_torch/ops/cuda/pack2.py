"""Wrapper of the CUDA dense pack (csrc/pack.cu): one kernel in place of
the Pallas pair K2 preshift (huffman_tpu/ops/pallas/pack2.py:332) and K3
tile pack (:383).  The kernel builds the stream tile by tile in shared
memory and writes every word of it once, so the output needs no zero
fill."""

from __future__ import annotations

import torch

from .. import Counter
from .. import pack as plain
from . import _build

SOURCE = "huffman_tpu_torch/csrc/pack.cu"
REPLACES = "huffman_tpu/ops/pallas/pack2.py:383"
launches = Counter()


def pack_blocks(streams: torch.Tensor, block_bits: torch.Tensor,
                word_base: torch.Tensor, bit_shift: torch.Tensor,
                n_words: int) -> torch.Tensor:
    """ops.pack.pack_blocks on the card; same arguments and result.  The
    offsets are those of ops.scan.exclusive_bit_offsets (word_base
    nondecreasing), and each stream is zero past its block's bits."""
    if streams.device.type == "cpu":
        return plain.pack_blocks(streams, block_bits, word_base, bit_shift,
                                 n_words)
    dev = streams.device
    if dev.type != "cuda":
        raise ValueError(f"pack_blocks: unsupported device {dev}")
    nb, cap = streams.shape
    _build.require(streams, "streams", torch.int32, (nb, cap), dev)
    _build.require(block_bits, "block_bits", torch.int32, (nb,), dev)
    _build.require(word_base, "word_base", torch.int64, (nb,), dev)
    _build.require(bit_shift, "bit_shift", torch.int32, (nb,), dev)
    out = torch.empty(n_words, dtype=torch.int32, device=dev)
    if n_words == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(dev):          # the launch uses the current device
        err = lib.huff_pack_blocks(
            streams.data_ptr(), block_bits.data_ptr(), word_base.data_ptr(),
            bit_shift.data_ptr(), out.data_ptr(), nb, cap, n_words,
            _build.stream_ptr(dev))
    _build.check(err, "pack")
    launches.n += 1
    return out
