"""Single-device codec API (counterpart of huffman_tpu/api.py, dense format).

encode: bytes to the device -> histogram (device) -> codebook (host) ->
K1 block encode (device) -> per-block bit counts to the host (miss and
overflow checks, container) -> int64 offset scan (device) -> pack
(device) -> stream words to the host.
decode: offset scan -> K4 decode of every block (device) -> bytes.

Every function takes `device`.  On a CUDA device the stages launch the
port's CUDA kernels; with device="cpu" the kernel wrappers run their plain
PyTorch versions.  Nothing detects a device on its own.

Left out against the JAX package, all Mosaic machinery: pow2 block
bucketing, chunked host staging, the capacity and tree speculation with
its patch overlay, and the sampled codebook (ROADMAP.md lists them).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import TYPE_CHECKING

import numpy as np
import torch

from .codebook import Codebook
from .config import DEFAULT_CONFIG, CodecConfig, cdiv
from .ops import histogram as hist_ops
from .ops.cuda import dense_decode as k_decode
from .ops.cuda import encode as k_encode
from .ops.cuda import pack2 as k_pack
from .ops.decode import table_entries
from .ops.encode import BITS_MASK, MISS_FLAG
from .ops.scan import exclusive_bit_offsets

if TYPE_CHECKING:
    from .models.base import CodebookModel


@dataclasses.dataclass(frozen=True)
class Encoded:
    """An encoded stream plus everything needed to decode it: the in-memory
    form of the .htz v1 container."""
    stream_words: np.ndarray      # (ceil(total_bits/32),) uint32
    total_bits: int
    block_bits: np.ndarray        # (NB,) int32
    codebook: Codebook
    n_bytes: int
    config: CodecConfig

    @property
    def stream_bytes(self) -> np.ndarray:
        """MSB-first byte view (bit-comparable with the golden codec)."""
        from .golden.numpy_codec import words_to_packed_bytes
        return words_to_packed_bytes(self.stream_words, self.total_bits)

    @property
    def ratio(self) -> float:
        return (self.total_bits / 8) / max(self.n_bytes, 1)


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)


def _from_numpy(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`.  Read-only arrays (views of bytes
    objects) are fine: the tensor is only read."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr).to(device)


def valid_per_block(n_bytes: int, num_blocks: int, block_bytes: int,
                    ) -> np.ndarray:
    """Real byte count of each block: block_bytes for full blocks, the
    remainder for the final partial block."""
    starts = np.arange(num_blocks, dtype=np.int64) * block_bytes
    return np.clip(n_bytes - starts, 0, block_bytes).astype(np.int32)


def device_rows(arr: np.ndarray, n_rows: int, row_bytes: int,
                device: torch.device):
    """(n_rows, row_bytes) uint8 rows of `arr` on `device`, zero past it
    (arr holds at most n_rows * row_bytes bytes), and the (n_rows,) int32
    valid byte counts.  The input goes to the device as it is: no padded
    copy is made on the host."""
    n = arr.size
    rows = torch.empty(n_rows * row_bytes, dtype=torch.uint8, device=device)
    rows[:n].copy_(_from_numpy(arr, torch.device("cpu")))
    rows[n:].zero_()
    valid = _from_numpy(valid_per_block(n, n_rows, row_bytes), device)
    return rows.view(n_rows, row_bytes), valid


def device_blocks(arr: np.ndarray, cfg: CodecConfig, device: torch.device):
    """(NB, block_bytes) uint8 blocks on `device`, zero past the input, and
    the (NB,) int32 valid byte counts."""
    return device_rows(arr, cfg.num_blocks(arr.size), cfg.block_bytes, device)


def codebook_tensors(cb: Codebook, device: torch.device):
    """The kernels' (256,) int32 codes (uint32 bit patterns) and lengths."""
    codes = _from_numpy(np.ascontiguousarray(cb.codes, np.uint32)
                        .view(np.int32), device)
    return codes, _from_numpy(np.ascontiguousarray(cb.lengths, np.int32),
                              device)


def _codebook_for(blocks: torch.Tensor, n: int, cfg: CodecConfig) -> Codebook:
    freqs = hist_ops.histogram(blocks, n).cpu().numpy()
    return Codebook.from_frequencies_auto(freqs, cfg.max_code_len,
                                          cfg.narrow_tol)


def build_codebook(data, cfg: CodecConfig = DEFAULT_CONFIG,
                   device="cuda") -> Codebook:
    """Histogram on `device` + host canonical codebook, with the
    cfg.narrow_tol cap policy of the JAX package."""
    arr = _as_u8(data)
    blocks, _ = device_blocks(arr, cfg, torch.device(device))
    return _codebook_for(blocks, arr.size, cfg)


def empty_encoded(cfg: CodecConfig, codebook: Codebook | None) -> Encoded:
    """The Encoded of an empty input: no words, one block of 0 bits."""
    return Encoded(np.zeros(0, np.uint32), 0, np.zeros(1, np.int32),
                   codebook or Codebook.from_lengths(np.zeros(256)), 0, cfg)


def check_block_bits(bits_raw: np.ndarray, cfg: CodecConfig) -> np.ndarray:
    """K1's raw per-block counts -> int32 bit counts, raising ValueError for
    a byte with no code (MISS_FLAG) and OverflowError for a block past the
    capacity (with cfg.check_overflow)."""
    raw = bits_raw.view(np.uint32)
    if (raw & MISS_FLAG).any():
        raise ValueError("input contains symbols absent from the codebook")
    block_bits = raw.astype(np.int32)
    cap = cfg.capacity_words
    if cfg.check_overflow and (block_bits > cap * 32).any():
        bad = int(np.argmax(block_bits > cap * 32))
        raise OverflowError(
            f"block {bad} needs {int(block_bits[bad])} bits > capacity "
            f"{cap * 32}; raise config.capacity_bits_per_byte")
    return block_bits


def encode(data, cfg: CodecConfig = DEFAULT_CONFIG,
           codebook: Codebook | None = None,
           model: "CodebookModel | None" = None, device="cuda") -> Encoded:
    """Encode a byte stream on `device`.

    The codebook comes from, in this order: `codebook`, then
    `model.codebook_for(data)` (models.CodebookModel; FixedCodebook skips
    the histogram), then the exact per-stream build.  A given or modelled
    codebook that lacks a code for some input byte raises ValueError."""
    arr = _as_u8(data)
    n = arr.size
    if n == 0:
        return empty_encoded(cfg, codebook)
    if codebook is None and model is not None:
        codebook = model.codebook_for(arr)
    device = torch.device(device)
    blocks, valid = device_blocks(arr, cfg, device)
    cb = codebook if codebook is not None else _codebook_for(blocks, n, cfg)
    if cb.max_len > 24:
        raise ValueError(f"codebook has {cb.max_len}-bit codes; at most 24")
    codes, lengths = codebook_tensors(cb, device)
    streams, bits_raw = k_encode.encode_blocks(blocks, codes, lengths, valid,
                                               cfg.capacity_words)
    # the one host sync of encode: the counts feed the checks, the total
    # and the container
    block_bits = check_block_bits(bits_raw.cpu().numpy(), cfg)
    total_bits = int(block_bits.astype(np.int64).sum())
    bits = bits_raw & BITS_MASK
    offsets = exclusive_bit_offsets(bits)
    stream = k_pack.pack_blocks(streams, bits, offsets.word_base,
                                offsets.bit_shift, cdiv(total_bits, 32))
    return Encoded(stream_words=stream.cpu().numpy().view(np.uint32),
                   total_bits=total_bits, block_bits=block_bits,
                   codebook=cb, n_bytes=n, config=cfg)


def encode_pipeline(blocks: torch.Tensor, codes: torch.Tensor,
                    lengths: torch.Tensor, valid: torch.Tensor,
                    capacity_words: int):
    """The device part of encode on device-resident inputs: K1 -> offset
    scan -> pack, with no checks.  Returns (stream words, raw block bits)
    on the blocks' device; reading the stream's length is one host sync."""
    streams, bits_raw = k_encode.encode_blocks(blocks, codes, lengths, valid,
                                               capacity_words)
    bits = bits_raw & BITS_MASK
    offsets = exclusive_bit_offsets(bits)
    return k_pack.pack_blocks(streams, bits, offsets.word_base,
                              offsets.bit_shift,
                              int(offsets.total_words)), bits_raw


def _decode_blocks(stream_words: np.ndarray, word_base: torch.Tensor,
                   bit_shift: torch.Tensor, valid: torch.Tensor,
                   cb: Codebook, block_bytes: int) -> torch.Tensor:
    device = word_base.device
    tb = max(cb.max_len, 1)
    table = _from_numpy(table_entries(cb, tb), device)
    stream = _from_numpy(np.ascontiguousarray(stream_words, np.uint32)
                         .view(np.int32), device)
    return k_decode.decode_blocks(stream, word_base, bit_shift, valid, table,
                                  tb, block_bytes)


def decode(enc: Encoded, device="cuda") -> np.ndarray:
    """Decode every block on `device`.  Returns the uint8 bytes."""
    if enc.n_bytes == 0:
        return np.zeros(0, np.uint8)
    device = torch.device(device)
    bb = enc.config.block_bytes
    nb = len(enc.block_bits)
    bits = _from_numpy(np.ascontiguousarray(enc.block_bits, np.int32), device)
    offsets = exclusive_bit_offsets(bits)
    valid = _from_numpy(valid_per_block(enc.n_bytes, nb, bb), device)
    out = _decode_blocks(enc.stream_words, offsets.word_base,
                         offsets.bit_shift, valid, enc.codebook, bb)
    return out.reshape(-1)[: enc.n_bytes].cpu().numpy()


def decode_block_span(enc: Encoded, b0: int, b1: int,
                      device) -> torch.Tensor:
    """K4 over blocks [b0, b1) alone: host offsets from the per-block bit
    counts, and only the span of the stream that covers those blocks goes
    to `device`.  Returns (b1 - b0, block_bytes) uint8 on `device`."""
    device = torch.device(device)
    bb = enc.config.block_bytes
    bits = np.asarray(enc.block_bits, np.int64)
    ends = np.cumsum(bits)
    starts = ends - bits
    word_base = starts >> 5
    w0 = int(word_base[b0])
    span = enc.stream_words[w0: cdiv(int(ends[b1 - 1]), 32)]
    valid = valid_per_block(enc.n_bytes, len(bits), bb)[b0:b1]
    return _decode_blocks(
        span, _from_numpy(word_base[b0:b1] - w0, device),
        _from_numpy((starts[b0:b1] & 31).astype(np.int32), device),
        _from_numpy(valid, device), enc.codebook, bb)


def decode_range(enc: Encoded, start: int, stop: int,
                 device="cuda") -> np.ndarray:
    """Decode bytes [start, stop) by decoding only the blocks that cover
    them (decode_block_span)."""
    if not 0 <= start <= stop <= enc.n_bytes:
        raise ValueError(f"range [{start}, {stop}) outside "
                         f"[0, {enc.n_bytes})")
    if start == stop:
        return np.zeros(0, np.uint8)
    bb = enc.config.block_bytes
    b0, b1 = start // bb, cdiv(stop, bb)
    out = decode_block_span(enc, b0, b1, device)
    return out.reshape(-1)[start - b0 * bb: stop - b0 * bb].cpu().numpy()


def roundtrip_ok(data, cfg: CodecConfig = DEFAULT_CONFIG,
                 device="cuda") -> bool:
    """Encode + decode on `device` and compare with the input."""
    arr = _as_u8(data)
    return bool(np.array_equal(decode(encode(arr, cfg, device=device),
                                      device=device), arr))
