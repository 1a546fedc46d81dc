"""Per-stream canonical Huffman model (huffman_tpu/models/huffman.py): the
histogram runs on `device` (ops/histogram), the tree and the canonical
codes on the host (codebook.py), with the cfg.narrow_tol cap policy."""

from __future__ import annotations

import numpy as np

from ..codebook import Codebook
from ..config import DEFAULT_CONFIG, CodecConfig
from .base import CodebookModel


class CanonicalHuffman(CodebookModel):
    def __init__(self, cfg: CodecConfig = DEFAULT_CONFIG, device="cuda"):
        self.cfg = cfg
        self.device = device

    @property
    def needs_histogram(self) -> bool:
        return True

    def codebook_for(self, data: np.ndarray) -> Codebook:
        from ..api import build_codebook
        return build_codebook(data, self.cfg, device=self.device)
