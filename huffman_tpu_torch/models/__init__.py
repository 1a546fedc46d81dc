"""Codebook models (huffman_tpu/models/): what assigns the code lengths.

  * models.huffman.CanonicalHuffman - the exact per-stream canonical
    Huffman codebook (device histogram + host tree), the default.
  * models.fixed.FixedCodebook - a static codebook agreed ahead of time,
    trained once on sample data: no histogram pass per stream.
"""

from .base import CodebookModel
from .fixed import FixedCodebook
from .huffman import CanonicalHuffman

__all__ = ["CodebookModel", "CanonicalHuffman", "FixedCodebook"]
