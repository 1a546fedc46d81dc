"""Wide (interleaved) format on one device (counterpart of huffman_tpu/wide.py).

Format spec: golden/wide_codec.py; in-memory form of container v3.

encode_wide: bytes to the device as (NS, 256) substream rows -> histogram
(device) + codebook (host) -> K5 substream encode -> one host sync for
the miss flags -> schedule kernel (bases, tile_words, pull masks) -> offset
scan kernel over 2 * tile_words, the tiles' payload offsets -> one host
sync for the payload length -> K7 emit straight into the payload ->
payload, tile_words and bases to the host.
decode_wide / decode_wide_range: host offsets from tile_words -> the
covering tiles' payload span to the device -> K8 over those tiles -> bytes.

Every function takes `device`: on a CUDA device the stages launch the
port's kernels; with device="cpu" the wrappers run their plain PyTorch
versions (ops/wide.py).

Against the JAX package: the port writes the spec's tile count,
max(1, cdiv(n, TILE_BYTES)); the JAX package rounds it up to a power of
two (a compile-cache device) and writes empty tiles, whose containers the
port reads all the same.  Left out, all Mosaic machinery: the narrow
speculative substream trees with their flags, patch overlay and
_spec_policy; the per-tile host assembly of scratch planes; and the
row-group alignment of the decode plan.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import api, transfer
from .codebook import Codebook
from .config import DEFAULT_CONFIG, CodecConfig, cdiv
from .golden.wide_codec import MAXLEN, N_SUB, ROUNDS, SUB_BYTES, TILE_BYTES
from .ops.cuda import scan as k_scan
from .ops.cuda import wide_decode as k_decode
from .ops.cuda import wide_emit as k_emit
from .ops.cuda import wide_encode as k_sub
from .ops.decode import table_entries
from .utils.timing import span


@dataclasses.dataclass(frozen=True)
class WideEncoded:
    """A wide-format encoded stream (in-memory form of container v3)."""
    payload_words: np.ndarray     # uint32: per tile, P0 then P1
    tile_words: np.ndarray        # (NT,) int32 plane words per tile
    bases: np.ndarray             # (NT, ROUNDS) int32 per-round pull bases
    codebook: Codebook
    n_bytes: int
    config: CodecConfig

    @property
    def ratio(self) -> float:
        return (self.payload_words.size * 4) / max(self.n_bytes, 1)


def num_tiles(n_bytes: int) -> int:
    return max(1, cdiv(n_bytes, TILE_BYTES))


def tile_bytes(n_bytes: int, t0: int, t1: int) -> np.ndarray:
    """(t1 - t0,) int32 real bytes of tiles [t0, t1)."""
    starts = np.arange(t0, t1, dtype=np.int64) * TILE_BYTES
    return np.clip(n_bytes - starts, 0, TILE_BYTES).astype(np.int32)


def reader_mcl(cb: Codebook) -> int:
    """The max code length that enters the pull rule: the codebook's
    actual longest code (not cfg.max_code_len), at least 1."""
    return int(cb.lengths.max(initial=1)) or 1


def slot_words(mcl: int) -> int:
    """K5's words per substream: 256 codes of at most mcl bits fill 8 * mcl
    words, and the emit may read the two after them."""
    return 8 * mcl + 2


def device_substreams(arr: np.ndarray, device: torch.device):
    """(NS, SUB_BYTES) uint8 substream rows on `device`, zero past the input
    (NS = N_SUB * num_tiles(n)), and the (NS,) int32 valid byte counts."""
    return transfer.device_rows(arr, num_tiles(arr.size) * N_SUB,
                                SUB_BYTES, device)


def payload_offsets(tile_words: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Each tile's first payload word (the int64 exclusive sum of its two
    planes, through the offset scan's kernel on a CUDA device) and the
    payload length, which is a host sync."""
    offsets, total = k_scan.payload_offsets(tile_words)
    return offsets, int(transfer.to_host(total))


def encode_substreams(rows: torch.Tensor, valid: torch.Tensor,
                      cb: Codebook, n_bytes: int):
    """K5 -> schedule -> offsets -> K7 on device-resident rows, in spans
    encode.pass (K5 and its miss sync), encode.schedule (the schedule, the
    offsets and the payload length's sync) and encode.emit.  Returns
    (payload (NW,) int32, tile_words (NT,) int32, bases (NT, ROUNDS) int32),
    all on the rows' device."""
    device = rows.device
    mcl = reader_mcl(cb)
    with span("encode.pass", cap=slot_words(mcl)):
        codes, lengths = api.codebook_tensors(cb, device)
        streams, bits, l2 = k_sub.sub_encode(rows, codes, lengths, valid,
                                             slot_words(mcl))
        # MISS_FLAG is the sign bit
        if bool(transfer.to_host((bits < 0).any())):
            raise ValueError(
                "input contains symbols absent from the codebook")
    with span("encode.schedule"):
        nt = rows.shape[0] // N_SUB
        tb = transfer.to_device(tile_bytes(n_bytes, 0, nt), device)
        bases, tile_words, masks = k_emit.schedule_counts(l2, tb, mcl)
        offsets, n_words = payload_offsets(tile_words)
    with span("encode.emit"):
        payload = k_emit.emit_planes(streams, masks, bases, tile_words,
                                     offsets, n_words)
    return payload, tile_words, bases


def encode_wide(data, cfg: CodecConfig = DEFAULT_CONFIG,
                codebook: Codebook | None = None,
                device="cuda") -> WideEncoded:
    """Encode into the wide format on `device`.  Without `codebook`, builds
    the exact per-stream codebook (device histogram, cfg.narrow_tol cap
    policy); an explicit codebook that lacks a code for some input byte
    raises ValueError, as do codes longer than 12 bits.  Its stages run in
    spans under a root "encode": encode.upload, encode.codebook,
    encode_substreams' three and encode.stream."""
    arr = api.as_u8(data)
    n = arr.size
    if cfg.max_code_len > MAXLEN:
        raise ValueError("wide format requires max_code_len <= 12")
    with span("encode", format="wide", bytes=n):
        with span("encode.upload"):
            rows, valid = device_substreams(arr, torch.device(device))
        if codebook is None:
            with span("encode.codebook"):
                codebook = api.codebook_for(rows, n, cfg)
        if codebook.max_len > MAXLEN:
            raise ValueError(f"codebook has {codebook.max_len}-bit codes; "
                             f"the wide format takes at most {MAXLEN}")
        payload, tile_words, bases = encode_substreams(rows, valid, codebook,
                                                       n)
        with span("encode.stream"):
            return WideEncoded(transfer.to_host(payload).view(np.uint32),
                               transfer.to_host(tile_words),
                               transfer.to_host(bases), codebook, n, cfg)


def _decode_tiles(enc: WideEncoded, t0: int, t1: int,
                  device) -> torch.Tensor:
    """K8 over tiles [t0, t1) of a wide stream: only their payload span
    goes to `device`.  Returns (t1 - t0, TILE_BYTES) uint8 on `device`.
    Spans decode.offsets (the host offsets and the per-tile tables),
    decode.upload (the payload span and the decode table) and
    decode.kernel."""
    device = torch.device(device)
    mcl = reader_mcl(enc.codebook)
    with span("decode.offsets"):
        tw = np.asarray(enc.tile_words, np.int64)
        tile_start = np.concatenate([[0], np.cumsum(2 * tw)])
        w0, w1 = int(tile_start[t0]), int(tile_start[t1])
        starts = transfer.to_device(tile_start[t0:t1] - w0, device)
        words = transfer.to_device(tw[t0:t1].astype(np.int32), device)
        bases = transfer.to_device(
            np.ascontiguousarray(enc.bases[t0:t1], np.int32), device)
        nbytes = transfer.to_device(tile_bytes(enc.n_bytes, t0, t1), device)
    with span("decode.upload"):
        payload = transfer.to_device(np.ascontiguousarray(
            enc.payload_words[w0:w1], np.uint32).view(np.int32), device)
        table = transfer.to_device(table_entries(enc.codebook, mcl), device)
    with span("decode.kernel"):
        return k_decode.decode_tiles(payload, starts, words, bases, nbytes,
                                     table, mcl)


def decode_wide(enc: WideEncoded, device="cuda") -> np.ndarray:
    """Decode every tile on `device`, under a root span "decode" (ending
    in decode.output).  Returns the uint8 bytes."""
    if enc.n_bytes == 0:
        return np.zeros(0, np.uint8)
    with span("decode", format="wide", bytes=enc.n_bytes):
        out = _decode_tiles(enc, 0, len(enc.tile_words), device)
        with span("decode.output"):
            return transfer.to_host(out.reshape(-1)[: enc.n_bytes])


def decode_wide_range(enc: WideEncoded, start: int, stop: int,
                      device="cuda") -> np.ndarray:
    """Decode bytes [start, stop) by decoding only the tiles that cover
    them: tiles are independent, since each carries its plane length and
    pull bases in the container."""
    if not 0 <= start <= stop <= enc.n_bytes:
        raise ValueError(f"range [{start}, {stop}) outside "
                         f"[0, {enc.n_bytes})")
    if start == stop:
        return np.zeros(0, np.uint8)
    t0, t1 = start // TILE_BYTES, cdiv(stop, TILE_BYTES)
    with span("decode", format="wide", range=True, bytes=stop - start):
        out = _decode_tiles(enc, t0, t1, device).reshape(-1)
        with span("decode.output"):
            return transfer.to_host(
                out[start - t0 * TILE_BYTES: stop - t0 * TILE_BYTES])


__all__ = ["WideEncoded", "encode_wide", "decode_wide", "decode_wide_range",
           "TILE_BYTES", "ROUNDS"]
