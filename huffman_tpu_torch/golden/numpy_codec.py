"""Word/byte views of the MSB-first stream (huffman_tpu/golden/numpy_codec.py).

Stream words are uint32 values whose bit 31 is the first stream bit, so the
big-endian byte view of the words is the MSB-first byte stream the golden
codec writes.
"""

from __future__ import annotations

import numpy as np


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
