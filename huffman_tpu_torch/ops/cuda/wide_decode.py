"""Wrapper of the CUDA wide decoder (K8, csrc/wide_decode.cu)."""

from __future__ import annotations

import torch

from .. import Counter
from .. import wide as plain
from . import _build

SOURCE = "huffman_tpu_torch/csrc/wide_decode.cu"
REPLACES = "huffman_tpu/ops/pallas/wide.py:265"
launches = Counter()

MAX_MCL = 12                        # the shared-memory table's width


def decode_tiles(payload: torch.Tensor, offsets: torch.Tensor,
                 tile_words: torch.Tensor, bases: torch.Tensor,
                 tile_bytes: torch.Tensor, table: torch.Tensor,
                 mcl: int) -> torch.Tensor:
    """ops.wide.decode_tiles on the card; same arguments and result."""
    if payload.device.type == "cpu":
        return plain.decode_tiles(payload, offsets, tile_words, bases,
                                  tile_bytes, table, mcl)
    dev = payload.device
    if dev.type != "cuda":
        raise ValueError(f"decode_tiles: unsupported device {dev}")
    mcl = int(mcl)
    if not 1 <= mcl <= MAX_MCL:
        raise ValueError(f"decode_tiles kernel takes mcl in [1, {MAX_MCL}], "
                         f"got {mcl}")
    nt = tile_bytes.shape[0]
    _build.require(payload, "payload", torch.int32, (payload.shape[0],), dev)
    _build.require(offsets, "offsets", torch.int64, (nt,), dev)
    _build.require(tile_words, "tile_words", torch.int32, (nt,), dev)
    _build.require(bases, "bases", torch.int32, (nt, plain.ROUNDS), dev)
    _build.require(tile_bytes, "tile_bytes", torch.int32, (nt,), dev)
    _build.require(table, "table", torch.int16, (1 << mcl,), dev)
    if payload.data_ptr() % 16:
        raise ValueError("decode_tiles kernel needs a 16-byte aligned payload")
    # every byte is written: zero past each substream's valid bytes
    out = torch.empty((nt, plain.N_SUB * plain.SUB_BYTES), dtype=torch.uint8,
                      device=dev)
    if nt == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(dev):          # the launch uses the current device
        err = lib.huff_wide_decode(
            payload.data_ptr(), payload.shape[0], offsets.data_ptr(),
            tile_words.data_ptr(), bases.data_ptr(), tile_bytes.data_ptr(),
            table.data_ptr(), mcl, out.data_ptr(), nt,
            _build.stream_ptr(dev))
    _build.check(err, "wide_decode")
    launches.n += 1
    return out
