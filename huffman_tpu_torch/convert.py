"""State carried between the two packages, as numpy fields.

A Huffman codec has no weights: its state is the codebook and the encoded
stream.  These functions build the port's Codebook, Encoded and
WideEncoded from the JAX package's fields (codes, lengths, max_len; stream
words, total_bits, block_bits, n_bytes, block_bytes, max_code_len; payload
words, tile_words, bases) and give the same fields back, so that either
package can take over the other's state without importing it.  The .htz
v1 and v3 bytes are the other shared form.
"""

from __future__ import annotations

import numpy as np

from .api import Encoded
from .codebook import Codebook, canonical_codes
from .config import CodecConfig, cdiv
from .golden.wide_codec import ROUNDS
from .wide import WideEncoded


def codebook_from_fields(codes, lengths, max_len: int) -> Codebook:
    """A port Codebook from a JAX codebook's fields.  Both packages build
    canonical codes, so the codes must be the canonical ones of the
    lengths; anything else raises."""
    lengths = np.asarray(lengths, dtype=np.int32)
    codes = np.asarray(codes, dtype=np.uint32)
    cb = Codebook.from_lengths(lengths)
    if not np.array_equal(codes, canonical_codes(lengths)) \
            or int(max_len) != cb.max_len:
        raise ValueError("codes or max_len are not the canonical codebook "
                         "of these lengths")
    return cb


def encoded_from_fields(stream_words, total_bits: int, block_bits,
                        n_bytes: int, block_bytes: int, max_code_len: int,
                        codebook: Codebook) -> Encoded:
    """A port Encoded from a JAX Encoded's fields."""
    words = np.asarray(stream_words, dtype=np.uint32)
    bits = np.asarray(block_bits, dtype=np.int32)
    if int(bits.astype(np.int64).sum()) != int(total_bits):
        raise ValueError("block_bits do not sum to total_bits")
    if words.size < cdiv(int(total_bits), 32):
        raise ValueError("stream_words shorter than total_bits")
    return Encoded(stream_words=words[: cdiv(int(total_bits), 32)],
                   total_bits=int(total_bits), block_bits=bits,
                   codebook=codebook, n_bytes=int(n_bytes),
                   config=CodecConfig(block_bytes=int(block_bytes),
                                      max_code_len=int(max_code_len)))


def codebook_fields(cb: Codebook) -> dict:
    return {"codes": cb.codes.copy(), "lengths": cb.lengths.copy(),
            "max_len": cb.max_len}


def encoded_fields(enc: Encoded) -> dict:
    return {"stream_words": enc.stream_words.copy(),
            "total_bits": enc.total_bits,
            "block_bits": enc.block_bits.copy(), "n_bytes": enc.n_bytes,
            "block_bytes": enc.config.block_bytes,
            "max_code_len": enc.config.max_code_len}


def wide_encoded_from_fields(payload_words, tile_words, bases, n_bytes: int,
                             max_code_len: int,
                             codebook: Codebook) -> WideEncoded:
    """A port WideEncoded from a JAX WideEncoded's fields."""
    words = np.asarray(payload_words, dtype=np.uint32)
    tw = np.asarray(tile_words, dtype=np.int32)
    bases = np.asarray(bases, dtype=np.int32)
    if bases.shape != (tw.size, ROUNDS):
        raise ValueError(f"bases shape {bases.shape} != ({tw.size}, {ROUNDS})")
    if words.size != 2 * int(tw.astype(np.int64).sum()):
        raise ValueError("payload_words size != 2 * sum(tile_words)")
    return WideEncoded(payload_words=words, tile_words=tw, bases=bases,
                       codebook=codebook, n_bytes=int(n_bytes),
                       config=CodecConfig(max_code_len=int(max_code_len)))


def wide_encoded_fields(enc: WideEncoded) -> dict:
    return {"payload_words": enc.payload_words.copy(),
            "tile_words": enc.tile_words.copy(), "bases": enc.bases.copy(),
            "n_bytes": enc.n_bytes, "max_code_len": enc.config.max_code_len}
