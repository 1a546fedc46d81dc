"""Wrapper of the CUDA block encoder (K1, csrc/encode.cu)."""

from __future__ import annotations

import torch

from .. import Counter
from .. import encode as plain
from . import _build

SOURCE = "huffman_tpu_torch/csrc/encode.cu"
REPLACES = "huffman_tpu/ops/pallas/encode.py:716"
launches = Counter()

# a block's bit count (codes of up to 24 bits) must fit the 31 bits below
# MISS_FLAG; any multiple of 4 up to that, at any capacity, encodes
MAX_BLOCK_BYTES = (2**31 - 1) // 24 // 4 * 4


def encode_blocks(byte_blocks: torch.Tensor, codes: torch.Tensor,
                  lengths: torch.Tensor, valid_bytes: torch.Tensor,
                  capacity_words: int, out=None):
    """ops.encode.encode_blocks on the card; same arguments and results.
    Code lengths must lie in [0, 24] (api.encode checks on the host).
    With out = (streams, bits), contiguous (NB, capacity_words) and (NB,)
    int32 tensors (streams at a 16-byte aligned address), the results are
    written there: a chunk of a larger encode writes its rows in place."""
    if byte_blocks.device.type == "cpu":
        res = plain.encode_blocks(byte_blocks, codes, lengths, valid_bytes,
                                  capacity_words)
        if out is None:
            return res
        out[0].copy_(res[0])
        out[1].copy_(res[1])
        return out
    dev = byte_blocks.device
    if dev.type != "cuda":
        raise ValueError(f"encode_blocks: unsupported device {dev}")
    nb, bb = byte_blocks.shape
    cap = int(capacity_words)
    if bb % 4 or not 0 < bb <= MAX_BLOCK_BYTES:
        raise ValueError(f"encode kernel needs block_bytes a multiple of 4 "
                         f"in [4, {MAX_BLOCK_BYTES}], got {bb}")
    if cap <= 0:
        raise ValueError(f"encode kernel needs capacity_words >= 1, got {cap}")
    _build.require(byte_blocks, "byte_blocks", torch.uint8, (nb, bb), dev)
    _build.require(codes, "codes", torch.int32, (256,), dev)
    _build.require(lengths, "lengths", torch.int32, (256,), dev)
    _build.require(valid_bytes, "valid_bytes", torch.int32, (nb,), dev)
    if out is None:
        streams = torch.empty((nb, cap), dtype=torch.int32, device=dev)
        bits = torch.empty(nb, dtype=torch.int32, device=dev)
    else:
        streams, bits = out
        _build.require(streams, "out streams", torch.int32, (nb, cap), dev)
        _build.require(bits, "out bits", torch.int32, (nb,), dev)
        if streams.data_ptr() % 16:
            raise ValueError("out streams: want a 16-byte aligned address")
    if nb == 0:
        return streams, bits
    lib = _build.load_library()
    with torch.cuda.device(dev):          # the launch uses the current device
        err = lib.huff_encode_blocks(
            byte_blocks.data_ptr(), codes.data_ptr(), lengths.data_ptr(),
            valid_bytes.data_ptr(), streams.data_ptr(), bits.data_ptr(), nb,
            bb, cap, _build.stream_ptr(dev))
    _build.check(err, "encode")
    launches.n += 1
    return streams, bits
