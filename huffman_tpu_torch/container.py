"""The .htz container, version 1 (dense), byte-identical to huffman_tpu's.

Layout (integers little-endian), as in huffman_tpu/container.py:

  offset  size  field
  0       4     magic  b"HTZ1"
  4       4     version (u32) = 1
  8       4     flags (u32; bit 0 = payload CRC-32 appended)
  12      8     original length in bytes (u64)
  20      4     block_bytes (u32)
  24      4     max_code_len (u32)
  28      8     total_bits (u64)
  36      4     num_blocks (u32)
  40      256   code lengths, one byte per symbol
  296     4*NB  per-block bit counts (u32 each)
  ...           payload: ceil(total_bits/32) words, each stored big-endian
                (the payload bytes are the MSB-first bitstream)
  ...     4     CRC-32 of the payload bytes (when flags bit 0 is set)

Version 3 (the wide format) is not ported yet; loading one raises.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .api import Encoded
from .codebook import Codebook
from .config import CodecConfig, cdiv

MAGIC = b"HTZ1"
VERSION = 1
WIDE_VERSION = 3
_HEADER = struct.Struct("<4sIIQIIQI")  # magic, ver, flags, n, bb, mcl, bits, nb
FLAG_CRC32 = 1


def overhead_bytes(num_blocks: int) -> int:
    """Container overhead for a given block count (header + tables)."""
    return _HEADER.size + 256 + 4 * num_blocks


def dumps(enc: Encoded, checksum: bool = True) -> bytes:
    """Serialize an Encoded stream to container bytes."""
    header = _HEADER.pack(MAGIC, VERSION, FLAG_CRC32 if checksum else 0,
                          enc.n_bytes, enc.config.block_bytes,
                          enc.config.max_code_len, enc.total_bits,
                          len(enc.block_bits))
    lens = np.asarray(enc.codebook.lengths, dtype=np.uint8).tobytes()
    bbits = np.asarray(enc.block_bits, dtype=np.uint32).tobytes()
    payload = np.ascontiguousarray(
        enc.stream_words[: cdiv(enc.total_bits, 32)],
        dtype=np.uint32).astype(">u4").tobytes()
    crc = (struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF)
           if checksum else b"")
    return header + lens + bbits + payload + crc


def container_version(blob: bytes) -> int:
    if len(blob) < _HEADER.size or blob[:4] != MAGIC:
        raise ValueError("not an HTZ container")
    return _HEADER.unpack_from(blob, 0)[1]


def loads(blob: bytes) -> Encoded:
    """Deserialize container bytes back to an Encoded stream."""
    if len(blob) < _HEADER.size:
        raise ValueError(
            f"not an HTZ container: {len(blob)} bytes < header size")
    magic, ver, flags, n_bytes, block_bytes, max_code_len, total_bits, nb = \
        _HEADER.unpack_from(blob, 0)
    if magic != MAGIC:
        raise ValueError(f"not an HTZ container (magic {magic!r})")
    if ver == WIDE_VERSION:
        raise ValueError("wide container not yet ported")
    if ver != VERSION:
        raise ValueError(f"unsupported container version {ver}")
    pay_off = overhead_bytes(nb)
    n_words = cdiv(total_bits, 32)
    if len(blob) < pay_off + 4 * n_words:
        raise ValueError("truncated HTZ container")
    if flags & FLAG_CRC32:
        if len(blob) < pay_off + 4 * n_words + 4:
            raise ValueError("truncated HTZ container (missing payload CRC)")
        want = struct.unpack_from("<I", blob, pay_off + 4 * n_words)[0]
        got = zlib.crc32(blob[pay_off: pay_off + 4 * n_words]) & 0xFFFFFFFF
        if got != want:
            raise ValueError(
                f"HTZ payload CRC mismatch (stored {want:#010x}, computed "
                f"{got:#010x}) — container corrupt")
    off = _HEADER.size
    lens = np.frombuffer(blob, dtype=np.uint8, count=256, offset=off)
    block_bits = np.frombuffer(blob, dtype=np.uint32, count=nb,
                               offset=off + 256).astype(np.int32)
    words = np.frombuffer(blob, dtype=">u4", count=n_words,
                          offset=pay_off).astype(np.uint32)
    return Encoded(stream_words=words, total_bits=total_bits,
                   block_bits=block_bits,
                   codebook=Codebook.from_lengths(lens.astype(np.int32)),
                   n_bytes=n_bytes,
                   config=CodecConfig(block_bytes=block_bytes,
                                      max_code_len=max_code_len))


def dump(enc: Encoded, path: str, checksum: bool = True) -> int:
    blob = dumps(enc, checksum)
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def load(path: str) -> Encoded:
    with open(path, "rb") as f:
        return loads(f.read())
