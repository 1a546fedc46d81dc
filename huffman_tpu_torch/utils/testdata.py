"""Synthetic test data (counterpart of huffman_tpu/utils/testdata.py).

The same seeds give the same bytes as the JAX package's generators.
In place of the JAX package's `entropy_fixture`, whose bisection draws the
whole stream once per step, `entropy_stream` makes a stream of any size
with the reference fixture's profile (32 symbols, H = 2.2066 bits/byte):
the decay is bisected on the distribution's exact entropy, and the bytes
are drawn once, chunk by chunk, from one seeded generator.
"""

from __future__ import annotations

import numpy as np

from ..codebook import entropy_bits_per_byte
from ..config import NUM_SYMBOLS

# Entropy of the reference's shipped 1 MiB sample, in bits/byte.
FIXTURE_ENTROPY = 2.206587175259


def uniform_random(n: int, num_symbols: int = NUM_SYMBOLS,
                   seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, num_symbols, size=n, dtype=np.uint8)


def skewed(n: int, num_symbols: int = 32, decay: float = 0.75,
           seed: int = 0) -> np.ndarray:
    """Geometrically skewed symbol distribution (compressible)."""
    rng = np.random.default_rng(seed)
    return rng.choice(num_symbols, size=n,
                      p=geometric_probs(num_symbols, decay)).astype(np.uint8)


def random_block_streams(bits, cap: int, seed: int = 0) -> np.ndarray:
    """(NB, cap) uint32 block streams whose row i holds exactly bits[i]
    random payload bits, MSB-first from word 0, and zeros after them: the
    pack stage's input without an encoder in front of it."""
    bits = np.asarray(bits, dtype=np.int64)
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(bits.size, cap), dtype=np.uint32)
    live = np.arange(cap, dtype=np.int64)[None, :] * 32 - bits[:, None]
    # live < -32: a full word; -32 < live < 0: the top -live bits
    keep = np.clip(-live, 0, 32).astype(np.uint64)
    mask = ((np.uint64(0xFFFFFFFF) << (np.uint64(32) - keep))
            & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.where(keep > 0, words & mask, 0).astype(np.uint32)


def geometric_probs(num_symbols: int, decay: float) -> np.ndarray:
    p = decay ** np.arange(num_symbols)
    return p / p.sum()


def decay_for_entropy(target_entropy: float = FIXTURE_ENTROPY,
                      num_symbols: int = 32) -> float:
    """Decay whose geometric distribution has exactly `target_entropy`,
    by bisection on the distribution's entropy (monotone in the decay)."""
    lo, hi = 1e-6, 1.0 - 1e-9
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if entropy_bits_per_byte(geometric_probs(num_symbols, mid)) < target_entropy:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def entropy_stream(n: int, target_entropy: float = FIXTURE_ENTROPY,
                   num_symbols: int = 32, seed: int = 0,
                   chunk: int = 64 << 20) -> np.ndarray:
    """n bytes drawn i.i.d. from the geometric distribution of entropy
    `target_entropy`, in `chunk`-byte draws from one seeded generator."""
    rng = np.random.default_rng(seed)
    p = geometric_probs(num_symbols, decay_for_entropy(target_entropy,
                                                       num_symbols))
    out = np.empty(n, dtype=np.uint8)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        out[i: i + m] = rng.choice(num_symbols, size=m, p=p)
    return out
