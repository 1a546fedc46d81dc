"""Pure-numpy twin of the golden codec, and word/byte views of the
MSB-first stream (huffman_tpu/golden/numpy_codec.py).

encode_bits spells out every output bit and packs them with np.packbits,
an algorithm independent of the C++ golden encoder's 64-bit accumulator,
so that the two agreeing checks the bitstream and not a shared bug.
Stream words are uint32 values whose bit 31 is the first stream bit, so the
big-endian byte view of the words is the MSB-first byte stream the golden
codec writes.
"""

from __future__ import annotations

import numpy as np

from ..codebook import Codebook


def encode_bits(data, cb: Codebook) -> tuple[np.ndarray, int]:
    """Encode to MSB-first packed bytes.  Returns (bytes, total_bits);
    raises ValueError for a byte with no code."""
    arr = (np.frombuffer(data, dtype=np.uint8)
           if isinstance(data, (bytes, bytearray))
           else np.asarray(data, dtype=np.uint8).reshape(-1))
    if arr.size == 0:
        return np.zeros(0, dtype=np.uint8), 0
    lens = cb.lengths.astype(np.int64)[arr]
    if np.any(lens == 0):
        bad = int(arr[np.argmax(lens == 0)])
        raise ValueError(f"symbol {bad} has no codeword")
    codes = cb.codes.astype(np.uint32)[arr]
    ends = np.cumsum(lens)
    total_bits = int(ends[-1])
    # one entry per output bit: its code, the code's length and start
    code_rep = np.repeat(codes, lens)
    len_rep = np.repeat(lens, lens)
    j = np.arange(total_bits, dtype=np.int64) - np.repeat(ends - lens, lens)
    bits = (code_rep >> (len_rep - 1 - j).astype(np.uint32)) & 1
    return np.packbits(bits.astype(np.uint8)), total_bits


def decode_bits(stream, total_bits: int, n_out: int, cb: Codebook,
                bit_offset: int = 0) -> np.ndarray:
    """Sequential table decode of n_out symbols from bit `bit_offset` of an
    MSB-first byte stream.  Raises ValueError on a prefix no code has, or
    when it reads past total_bits."""
    syms, lens = cb.decode_table()
    tb = max(cb.max_len, 1)
    bits = np.unpackbits(np.ascontiguousarray(stream, dtype=np.uint8))
    # zeros past the end, so that a table-wide peek stays in range
    bits = np.concatenate([bits, np.zeros(tb + 32, dtype=np.uint8)])
    weights = (1 << np.arange(tb - 1, -1, -1)).astype(np.int64)
    out = np.zeros(n_out, dtype=np.uint8)
    cur = bit_offset
    for k in range(n_out):
        idx = int(bits[cur: cur + tb] @ weights)
        L = int(lens[idx])
        if L == 0:
            raise ValueError(f"corrupt stream at bit {cur}")
        out[k] = syms[idx]
        cur += L
    if cur > total_bits + bit_offset:
        raise ValueError("decode consumed past end of stream")
    return out


def packed_bytes_to_words(packed: np.ndarray) -> np.ndarray:
    """View an MSB-first byte stream as uint32 stream words."""
    packed = np.asarray(packed, dtype=np.uint8)
    pad = (-len(packed)) % 4
    if pad:
        packed = np.concatenate([packed, np.zeros(pad, dtype=np.uint8)])
    return packed.view(">u4").astype(np.uint32)


def words_to_packed_bytes(words: np.ndarray, total_bits: int) -> np.ndarray:
    """Inverse of packed_bytes_to_words, truncated to ceil(total_bits/8)."""
    b = np.ascontiguousarray(words, dtype=np.uint32).astype(">u4").view(np.uint8)
    return b[: (total_bits + 7) // 8].copy()
