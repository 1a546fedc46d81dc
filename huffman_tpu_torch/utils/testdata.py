"""Synthetic test data (counterpart of huffman_tpu/utils/testdata.py).

The same seeds give the same bytes as the JAX package's generators,
`entropy_fixture` included, whose bisection draws the whole stream once a
step.  `entropy_stream` makes a stream of any size with the same profile
(32 symbols, H = 2.2066 bits/byte) for the cost of one draw: the decay is
bisected on the distribution's exact entropy, and the bytes are drawn
once, chunk by chunk, from one seeded generator.
"""

from __future__ import annotations

import numpy as np

from ..codebook import Codebook, byte_histogram_host, entropy_bits_per_byte
from ..config import NUM_SYMBOLS

# Entropy of the reference's shipped 1 MiB sample, in bits/byte.
FIXTURE_ENTROPY = 2.206587175259


def rle_runs(n: int, run_len: int = 32, num_symbols: int = 16,
             seed: int = 0) -> np.ndarray:
    """Runs of run_len equal bytes, each run's symbol drawn at random."""
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, num_symbols, size=-(-n // run_len), dtype=np.uint8)
    return np.repeat(syms, run_len)[:n]


def dummy_codebook(num_symbols: int = NUM_SYMBOLS) -> Codebook:
    """A valid prefix code that is no Huffman code: symbol i wants length
    (1, 2, 3, 4, 4, 5, 6, 7)[i % 8], deepened (up to 24 bits) until the
    remaining symbols still fit the Kraft budget at 24 bits each."""
    lengths = np.zeros(NUM_SYMBOLS, dtype=np.int32)
    budget = 1.0
    want = [1, 2, 3, 4, 4, 5, 6, 7]
    for i in range(num_symbols):
        L = want[i % len(want)]
        while (2.0 ** -L > budget - (num_symbols - i - 1) * 2.0 ** -24
               and L < 24):
            L += 1
        lengths[i] = L
        budget -= 2.0 ** -L
    return Codebook.from_lengths(lengths)


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


def entropy_fixture(n: int = 1 << 20, target_entropy: float = FIXTURE_ENTROPY,
                    num_symbols: int = 32, seed: int = 1024) -> np.ndarray:
    """n bytes of a geometric distribution over num_symbols bytes whose
    decay is bisected until the drawn bytes' entropy is within 1e-3 bits
    of target_entropy (at most 40 draws of the whole stream from one
    generator; the last draw is returned)."""
    rng = np.random.default_rng(seed)
    lo, hi = 0.05, 0.999
    data = None
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        data = rng.choice(num_symbols, size=n,
                          p=geometric_probs(num_symbols, mid)).astype(np.uint8)
        h = entropy_bits_per_byte(byte_histogram_host(data))
        if abs(h - target_entropy) < 1e-3:
            break
        if h < target_entropy:
            lo = mid
        else:
            hi = mid
    return data


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
