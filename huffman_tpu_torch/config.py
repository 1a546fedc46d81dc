"""Runtime configuration of the codec (counterpart of huffman_tpu/config.py).

Same knobs, order and defaults as the JAX package.  One is accepted and
checked but steers nothing: `table_bits` (the decoder sizes its table from
the codebook's own longest code).
"""

from __future__ import annotations

import dataclasses

# The symbol alphabet is bytes; stream words are 32-bit, MSB-first.
NUM_SYMBOLS = 256
WORD_BITS = 32
WORD_BYTES = 4


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """All runtime knobs of the codec.

    Attributes:
      block_bytes: bytes per independently encoded block (multiple of 4).
      max_code_len: codeword length cap in bits, enforced by package-merge.
      capacity_bits_per_byte: per-block encoded capacity, in bits per input
        byte; a block that needs more raises OverflowError when
        check_overflow is set.
      check_overflow: verify on the host that no block overflowed.
      table_bits: decoder lookup-table width, at least max_code_len; the
        JAX package's Mosaic decoder reads it, the port's does not.
      narrow_tol: relative size tolerance for preferring a cap-4/cap-8
        codebook (Codebook.from_frequencies_auto); 0 disables.
      spec_bits_per_byte: speculative per-block capacity, in bits per
        input byte, that encode tries first on the kernel path when the
        codebook's expected rate is at least 0.75 below it
        (api._cap_schedule); 0 disables speculation.
    """

    block_bytes: int = 1024
    max_code_len: int = 12
    capacity_bits_per_byte: int = 8
    check_overflow: bool = True
    table_bits: int | None = None
    narrow_tol: float = 0.01
    spec_bits_per_byte: int = 4

    def __post_init__(self):
        if self.block_bytes % WORD_BYTES != 0:
            raise ValueError("block_bytes must be a multiple of 4")
        if not (1 <= self.max_code_len <= 24):
            raise ValueError("max_code_len must be in [1, 24]")
        if self.table_bits is not None and self.table_bits < self.max_code_len:
            raise ValueError("table_bits must be >= max_code_len")

    @property
    def block_words(self) -> int:
        return self.block_bytes // WORD_BYTES

    @property
    def capacity_words(self) -> int:
        """Encoded-output capacity per block, in 32-bit words."""
        return cdiv(self.block_bytes * self.capacity_bits_per_byte, WORD_BITS)

    @property
    def decode_table_bits(self) -> int:
        return (self.table_bits if self.table_bits is not None
                else self.max_code_len)

    def num_blocks(self, n_bytes: int) -> int:
        """Blocks needed for an n-byte stream (the last may be partial)."""
        return max(1, cdiv(n_bytes, self.block_bytes))

    def padded_bytes(self, n_bytes: int) -> int:
        return self.num_blocks(n_bytes) * self.block_bytes


DEFAULT_CONFIG = CodecConfig()
