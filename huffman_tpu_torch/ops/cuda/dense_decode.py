"""Wrapper of the CUDA dense decoder (K4, csrc/dense_decode.cu)."""

from __future__ import annotations

import torch

from .. import Counter
from .. import decode as plain
from . import _build

SOURCE = "huffman_tpu_torch/csrc/dense_decode.cu"
REPLACES = "huffman_tpu/ops/pallas/dense_decode.py:378"
launches = Counter()

MAX_TABLE_BITS = 24                 # the longest code the encoder takes


def decode_blocks(stream: torch.Tensor, word_base: torch.Tensor,
                  bit_shift: torch.Tensor, valid_bytes: torch.Tensor,
                  table: torch.Tensor, table_bits: int,
                  block_bytes: int) -> torch.Tensor:
    """ops.decode.decode_blocks on the card; same arguments and result."""
    if stream.device.type == "cpu":
        return plain.decode_blocks(stream, word_base, bit_shift, valid_bytes,
                                   table, table_bits, block_bytes)
    dev = stream.device
    if dev.type != "cuda":
        raise ValueError(f"decode_blocks: unsupported device {dev}")
    if not 1 <= table_bits <= MAX_TABLE_BITS:
        raise ValueError(f"decode kernel takes table_bits in "
                         f"[1, {MAX_TABLE_BITS}], got {table_bits}")
    if block_bytes % 4 or block_bytes <= 0:
        raise ValueError("decode kernel needs block_bytes a multiple of 4")
    nb = word_base.shape[0]
    _build.require(stream, "stream", torch.int32, (stream.shape[0],), dev)
    _build.require(word_base, "word_base", torch.int64, (nb,), dev)
    _build.require(bit_shift, "bit_shift", torch.int32, (nb,), dev)
    _build.require(valid_bytes, "valid_bytes", torch.int32, (nb,), dev)
    _build.require(table, "table", torch.int16, (1 << table_bits,), dev)
    if stream.data_ptr() % 16:
        raise ValueError("decode kernel needs a 16-byte aligned stream")
    out = torch.empty((nb, block_bytes), dtype=torch.uint8, device=dev)
    if nb == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(dev):          # the launch uses the current device
        err = lib.huff_decode_blocks(
            stream.data_ptr(), stream.shape[0], word_base.data_ptr(),
            bit_shift.data_ptr(), valid_bytes.data_ptr(), table.data_ptr(),
            table_bits, out.data_ptr(), nb, block_bytes,
            _build.stream_ptr(dev))
    _build.check(err, "dense_decode")
    launches.n += 1
    return out
