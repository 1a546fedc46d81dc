"""Codebook model interface."""

from __future__ import annotations

import abc

import numpy as np

from ..codebook import Codebook


class CodebookModel(abc.ABC):
    """Maps input data to the codebook used to encode it."""

    @abc.abstractmethod
    def codebook_for(self, data: np.ndarray) -> Codebook:
        """Return the codebook to encode `data` with."""

    @property
    @abc.abstractmethod
    def needs_histogram(self) -> bool:
        """Whether encoding requires a histogram pass over the data."""
