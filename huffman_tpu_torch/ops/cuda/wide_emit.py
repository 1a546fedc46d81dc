"""Wrappers of the CUDA wide schedule and emit (K6 + K7, csrc/wide_emit.cu).

Two kernels, one pass each over the tiles: schedule_counts (the pull
schedule: per-round bases and each tile's plane length) and emit_planes
(the container payload).  `launches` counts the emit kernel and
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


def _check_common(l2: torch.Tensor, tile_bytes: torch.Tensor, mcl: int,
                  what: str) -> tuple[torch.device, int]:
    dev = l2.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if not 1 <= mcl <= MAX_MCL:
        raise ValueError(f"{what} kernel takes mcl in [1, {MAX_MCL}], "
                         f"got {mcl}")
    nt = tile_bytes.shape[0]
    _build.require(tile_bytes, "tile_bytes", torch.int32, (nt,), dev)
    _build.require(l2, "l2", torch.uint8, (nt * plain.N_SUB, plain.ITEMS),
                   dev)
    return dev, nt


def schedule_counts(l2: torch.Tensor, tile_bytes: torch.Tensor, mcl: int):
    """ops.wide.schedule_counts on the card; same arguments and results."""
    if l2.device.type == "cpu":
        return plain.schedule_counts(l2, tile_bytes, mcl)
    dev, nt = _check_common(l2, tile_bytes, int(mcl), "schedule_counts")
    bases = torch.empty((nt, plain.ROUNDS), dtype=torch.int32, device=dev)
    tile_words = torch.empty(nt, dtype=torch.int32, device=dev)
    if nt == 0:
        return bases, tile_words
    lib = _build.load_library()
    with torch.cuda.device(dev):          # the launch uses the current device
        err = lib.huff_wide_schedule(
            l2.data_ptr(), tile_bytes.data_ptr(), bases.data_ptr(),
            tile_words.data_ptr(), nt, int(mcl), _build.stream_ptr(dev))
    _build.check(err, "wide_schedule")
    schedule_launches.n += 1
    return bases, tile_words


def emit_planes(streams: torch.Tensor, l2: torch.Tensor,
                tile_bytes: torch.Tensor, bases: torch.Tensor,
                tile_words: torch.Tensor, offsets: torch.Tensor, mcl: int,
                n_words: int) -> torch.Tensor:
    """ops.wide.emit_planes on the card; same arguments and result."""
    if streams.device.type == "cpu":
        return plain.emit_planes(streams, l2, tile_bytes, bases, tile_words,
                                 offsets, mcl, n_words)
    dev, nt = _check_common(l2, tile_bytes, int(mcl), "emit_planes")
    ns, slot = streams.shape
    if not 0 < slot <= MAX_SLOT:
        raise ValueError(f"emit_planes kernel takes slot in [1, {MAX_SLOT}],"
                         f" got {slot}")
    _build.require(streams, "streams", torch.int32, (nt * plain.N_SUB, slot),
                   dev)
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
            streams.data_ptr(), slot, l2.data_ptr(), tile_bytes.data_ptr(),
            bases.data_ptr(), tile_words.data_ptr(), offsets.data_ptr(), nt,
            int(mcl), payload.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "wide_emit")
    launches.n += 1
    return payload
