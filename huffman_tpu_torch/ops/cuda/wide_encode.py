"""Wrapper of the CUDA substream encoder (K5, csrc/wide_encode.cu)."""

from __future__ import annotations

import torch

from .. import Counter
from .. import wide as plain
from . import _build

SOURCE = "huffman_tpu_torch/csrc/wide_encode.cu"
REPLACES = "huffman_tpu/wide.py:153"
launches = Counter()

MAX_SLOT = 8 * 12 + 2               # a 12-bit book's substream, plus two


def sub_encode(substreams: torch.Tensor, codes: torch.Tensor,
               lengths: torch.Tensor, valid: torch.Tensor, slot: int):
    """ops.wide.sub_encode on the card; same arguments and results.
    Code lengths must lie in [0, 12] (wide.encode_wide checks on the
    host)."""
    if substreams.device.type == "cpu":
        return plain.sub_encode(substreams, codes, lengths, valid, slot)
    dev = substreams.device
    if dev.type != "cuda":
        raise ValueError(f"sub_encode: unsupported device {dev}")
    slot = int(slot)
    if not 0 < slot <= MAX_SLOT:
        raise ValueError(f"sub_encode kernel takes slot in [1, {MAX_SLOT}], "
                         f"got {slot}")
    ns = substreams.shape[0]
    _build.require(substreams, "substreams", torch.uint8,
                   (ns, plain.SUB_BYTES), dev)
    _build.require(codes, "codes", torch.int32, (256,), dev)
    _build.require(lengths, "lengths", torch.int32, (256,), dev)
    _build.require(valid, "valid", torch.int32, (ns,), dev)
    streams = torch.empty((ns, slot), dtype=torch.int32, device=dev)
    bits = torch.empty(ns, dtype=torch.int32, device=dev)
    l2 = torch.empty((ns, plain.ITEMS), dtype=torch.uint8, device=dev)
    if ns == 0:
        return streams, bits, l2
    if substreams.data_ptr() % 16:
        raise ValueError("sub_encode kernel needs 16-byte aligned substreams")
    lib = _build.load_library()
    with torch.cuda.device(dev):          # the launch uses the current device
        err = lib.huff_wide_sub_encode(
            substreams.data_ptr(), codes.data_ptr(), lengths.data_ptr(),
            valid.data_ptr(), streams.data_ptr(), bits.data_ptr(),
            l2.data_ptr(), ns, slot, _build.stream_ptr(dev))
    _build.check(err, "wide_sub_encode")
    launches.n += 1
    return streams, bits, l2
