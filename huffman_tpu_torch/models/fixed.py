"""Fixed (static) codebook model (huffman_tpu/models/fixed.py).

A codebook agreed ahead of time, trained on sample data or constructed,
and reused across streams: encoding skips the histogram pass.
"""

from __future__ import annotations

import numpy as np

from ..codebook import Codebook, byte_histogram_host
from ..config import DEFAULT_CONFIG, CodecConfig
from .base import CodebookModel


class FixedCodebook(CodebookModel):
    def __init__(self, codebook: Codebook):
        codebook.validate()
        self.codebook = codebook

    @property
    def needs_histogram(self) -> bool:
        return False

    def codebook_for(self, data: np.ndarray) -> Codebook:
        return self.codebook

    @staticmethod
    def train(sample: np.ndarray,
              cfg: CodecConfig = DEFAULT_CONFIG) -> "FixedCodebook":
        """Fit a fixed codebook on sample data (host histogram).

        Every one of the 256 symbols gets a nonzero frequency (add-one
        smoothing), so every later stream is encodable.
        """
        freqs = byte_histogram_host(sample) + 1
        return FixedCodebook(Codebook.from_frequencies(freqs, cfg.max_code_len))
