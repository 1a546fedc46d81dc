"""Wrappers of the CUDA wide schedule and emit (K6 + K7, csrc/wide_emit.cu).

Two kernels, one CTA a tile each: schedule_counts (the pull schedule:
per-round bases, each tile's plane length and each substream's 64-bit
pull mask, from l2, which must be 16-byte aligned) and emit_planes (the
container payload, from the masks).  `launches` counts the emit kernel and
`schedule_launches` the schedule kernel.
"""

from __future__ import annotations

import torch

from .. import Counter
from .. import wide as plain
from . import _build
from .wide_encode import MAX_SLOT

SOURCE = "huffman_tpu_torch/csrc/wide_emit.cu"
REPLACES = "huffman_tpu/ops/pallas/wide.py:702"
launches = Counter()
schedule_launches = Counter()

MAX_MCL = 12


def schedule_counts(l2: torch.Tensor, tile_bytes: torch.Tensor, mcl: int):
    """ops.wide.schedule_counts on the card; same arguments and results."""
    if l2.device.type == "cpu":
        return plain.schedule_counts(l2, tile_bytes, mcl)
    dev = l2.device
    if dev.type != "cuda":
        raise ValueError(f"schedule_counts: unsupported device {dev}")
    if not 1 <= mcl <= MAX_MCL:
        raise ValueError(f"schedule_counts kernel takes mcl in "
                         f"[1, {MAX_MCL}], got {mcl}")
    nt = tile_bytes.shape[0]
    _build.require(tile_bytes, "tile_bytes", torch.int32, (nt,), dev)
    _build.require(l2, "l2", torch.uint8, (nt * plain.N_SUB, plain.ITEMS),
                   dev)
    if l2.data_ptr() % 16:
        raise ValueError("schedule_counts kernel needs a 16-byte aligned l2")
    bases = torch.empty((nt, plain.ROUNDS), dtype=torch.int32, device=dev)
    tile_words = torch.empty(nt, dtype=torch.int32, device=dev)
    masks = torch.empty(nt * plain.N_SUB, dtype=torch.int64, device=dev)
    if nt == 0:
        return bases, tile_words, masks
    lib = _build.load_library()
    with torch.cuda.device(dev):          # the launch uses the current device
        err = lib.huff_wide_schedule(
            l2.data_ptr(), tile_bytes.data_ptr(), bases.data_ptr(),
            tile_words.data_ptr(), masks.data_ptr(), nt, int(mcl),
            _build.stream_ptr(dev))
    _build.check(err, "wide_schedule")
    schedule_launches.n += 1
    return bases, tile_words, masks


def emit_planes(streams: torch.Tensor, masks: torch.Tensor,
                bases: torch.Tensor, tile_words: torch.Tensor,
                offsets: torch.Tensor, n_words: int) -> torch.Tensor:
    """ops.wide.emit_planes on the card; same arguments and result."""
    if streams.device.type == "cpu":
        return plain.emit_planes(streams, masks, bases, tile_words, offsets,
                                 n_words)
    dev = streams.device
    if dev.type != "cuda":
        raise ValueError(f"emit_planes: unsupported device {dev}")
    nt = bases.shape[0]
    ns, slot = streams.shape
    if not 0 < slot <= MAX_SLOT:
        raise ValueError(f"emit_planes kernel takes slot in [1, {MAX_SLOT}],"
                         f" got {slot}")
    _build.require(streams, "streams", torch.int32, (nt * plain.N_SUB, slot),
                   dev)
    if streams.data_ptr() % 8:
        raise ValueError("emit_planes kernel needs 8-byte aligned streams")
    _build.require(masks, "masks", torch.int64, (nt * plain.N_SUB,), dev)
    _build.require(bases, "bases", torch.int32, (nt, plain.ROUNDS), dev)
    _build.require(tile_words, "tile_words", torch.int32, (nt,), dev)
    _build.require(offsets, "offsets", torch.int64, (nt,), dev)
    # every payload word is written: P0 and P1 of every tile are filled
    payload = torch.empty(int(n_words), dtype=torch.int32, device=dev)
    if nt == 0 or n_words == 0:
        return payload
    lib = _build.load_library()
    with torch.cuda.device(dev):          # the launch uses the current device
        err = lib.huff_wide_emit(
            streams.data_ptr(), slot, masks.data_ptr(), bases.data_ptr(),
            tile_words.data_ptr(), offsets.data_ptr(), nt, payload.data_ptr(),
            _build.stream_ptr(dev))
    _build.check(err, "wide_emit")
    launches.n += 1
    return payload
