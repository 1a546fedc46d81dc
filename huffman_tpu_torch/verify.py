"""Differential checks against the golden codec (huffman_tpu/verify.py)."""

from __future__ import annotations

import dataclasses

import numpy as np

from . import golden
from .api import Encoded, as_u8, decode
from .golden.numpy_codec import packed_bytes_to_words


@dataclasses.dataclass(frozen=True)
class VerifyResult:
    ok: bool
    detail: str

    def __bool__(self) -> bool:
        return self.ok


def verify_encoded(enc: Encoded, data) -> VerifyResult:
    """Bit-exact comparison of an encoded stream with the golden encoder."""
    ref_bytes, ref_bits = golden.encode(as_u8(data), enc.codebook)
    if enc.total_bits != ref_bits:
        return VerifyResult(False, f"bit count {enc.total_bits} != golden {ref_bits}")
    ref_words = packed_bytes_to_words(ref_bytes)
    if not np.array_equal(enc.stream_words, ref_words):
        bad = np.flatnonzero(enc.stream_words[: ref_words.size]
                             != ref_words[: enc.stream_words.size])
        first = int(bad[0]) if bad.size else min(enc.stream_words.size,
                                                  ref_words.size)
        return VerifyResult(
            False, f"stream words differ from golden (first at word {first}; "
                   f"{enc.stream_words.size} vs {ref_words.size} words)")
    return VerifyResult(True, f"bit-exact: {ref_bits} bits")


def verify_roundtrip(enc: Encoded, data, device="cuda") -> VerifyResult:
    """Decode on `device` and compare with the original bytes."""
    arr = as_u8(data)
    back = decode(enc, device=device)
    if back.shape != arr.shape:
        return VerifyResult(False, f"length {back.size} != {arr.size}")
    bad = np.flatnonzero(back != arr)
    if bad.size:
        i = int(bad[0])
        return VerifyResult(
            False, f"{bad.size} byte mismatches; first at {i}: "
                   f"{int(back[i])} != {int(arr[i])}")
    return VerifyResult(True, f"roundtrip exact: {arr.size} bytes")
