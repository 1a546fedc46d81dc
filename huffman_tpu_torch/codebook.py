"""Canonical Huffman codebook construction (host side, numpy).

Counterpart of huffman_tpu/codebook.py: the same greedy Huffman lengths,
the same package-merge length cap, the same canonical code assignment and
the same narrow-cap policy, so both packages give identical `lengths` and
`codes` for the same histogram, and the same speculation estimates
(est_bpb and the window-overflow fractions est_w*_frac).
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from .config import NUM_SYMBOLS


def byte_histogram_host(data) -> np.ndarray:
    """256-bin byte histogram on the host (int64)."""
    arr = (np.frombuffer(data, dtype=np.uint8)
           if isinstance(data, (bytes, bytearray))
           else np.asarray(data, dtype=np.uint8))
    return np.bincount(arr.reshape(-1), minlength=NUM_SYMBOLS).astype(np.int64)


def entropy_bits_per_byte(freqs: np.ndarray) -> float:
    """Shannon entropy of the source, in bits/byte."""
    freqs = np.asarray(freqs, dtype=np.float64)
    total = freqs.sum()
    if total == 0:
        return 0.0
    p = freqs[freqs > 0] / total
    return float(-(p * np.log2(p)).sum())


def huffman_code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Unrestricted Huffman code lengths (greedy two-minimum merge)."""
    freqs = np.asarray(freqs, dtype=np.int64)
    syms = np.flatnonzero(freqs)
    lengths = np.zeros(NUM_SYMBOLS, dtype=np.int32)
    if len(syms) == 0:
        return lengths
    if len(syms) == 1:
        lengths[syms[0]] = 1
        return lengths
    # (freq, tiebreak, leaf symbols): the tiebreak makes the merge order,
    # and so the lengths, identical to the JAX package's.
    heap = [(int(freqs[s]), int(s), [int(s)]) for s in syms]
    heapq.heapify(heap)
    tb = NUM_SYMBOLS
    while len(heap) > 1:
        fa, _, a = heapq.heappop(heap)
        fb, _, b = heapq.heappop(heap)
        for s in a + b:
            lengths[s] += 1
        heapq.heappush(heap, (fa + fb, tb, a + b))
        tb += 1
    return lengths


def package_merge_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Optimal code lengths subject to length <= max_len (package-merge)."""
    freqs = np.asarray(freqs, dtype=np.int64)
    syms = np.flatnonzero(freqs)
    n = len(syms)
    lengths = np.zeros(NUM_SYMBOLS, dtype=np.int32)
    if n == 0:
        return lengths
    if n == 1:
        lengths[syms[0]] = 1
        return lengths
    if n > (1 << max_len):
        raise ValueError(f"cannot code {n} symbols with max length {max_len}")
    orig = sorted((int(freqs[s]), (int(s),)) for s in syms)
    pkg = list(orig)
    for _ in range(max_len - 1):
        paired = [(pkg[i][0] + pkg[i + 1][0], pkg[i][1] + pkg[i + 1][1])
                  for i in range(0, len(pkg) - 1, 2)]
        pkg = sorted(orig + paired)
    for _, symset in pkg[: 2 * n - 2]:
        for s in symset:
            lengths[s] += 1
    return lengths


def kraft_sum(lengths: np.ndarray) -> float:
    """Sum of 2**-L over the present symbols: at most 1 for a prefix code."""
    nz = np.asarray(lengths)
    nz = nz[nz > 0].astype(np.float64)
    return float(np.sum(2.0 ** (-nz)))


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical right-aligned code values: symbols ordered by (length,
    value), codes counting up and left-shifted when the length grows."""
    lengths = np.asarray(lengths, dtype=np.int32)
    codes = np.zeros(NUM_SYMBOLS, dtype=np.uint32)
    order = np.lexsort((np.arange(NUM_SYMBOLS), lengths))
    code = 0
    prev_len = 0
    for s in order:
        L = int(lengths[s])
        if L == 0:
            continue
        if prev_len:
            code <<= L - prev_len
        codes[s] = code
        code += 1
        prev_len = L
    return codes


def _window_overflow_fracs(freqs: np.ndarray,
                           lengths: np.ndarray
                           ) -> tuple[float, float, float]:
    """(P[a 1 KiB block has a 4-byte window of more than 32 bits], the same
    for 4- or 8-byte windows, P[a block has a 16-byte window of more than
    64 bits]), exact for independent bytes: the code-length pmf convolved
    to aligned 4-, 8- and 16-byte window sums, of which a block has 256,
    128 and 64."""
    f = np.asarray(freqs, dtype=np.float64)
    tot = f.sum()
    if tot <= 0:
        return 0.0, 0.0, 0.0
    pmf = np.zeros(int(lengths.max(initial=0)) + 1)
    np.add.at(pmf, np.asarray(lengths, np.int64), f / tot)
    w2 = np.convolve(pmf, pmf)
    w4 = np.convolve(w2, w2)
    p4 = float(w4[33:].sum())
    w8 = np.convolve(w4, w4)
    p8 = float(w8[33:].sum())
    w16 = np.convolve(w8, w8)
    p16 = float(w16[65:].sum())
    return (float(1 - (1 - p4) ** 256),
            float(1 - (1 - p4) ** 256 * (1 - p8) ** 128),
            float(1 - (1 - p16) ** 64))


@dataclasses.dataclass(frozen=True)
class Codebook:
    """A canonical Huffman codebook over the byte alphabet.

    `codes[s]` is the right-aligned codeword of byte s and `lengths[s]` its
    bit length (0 = symbol absent).

    The estimates come from the histogram the book was built from, and are
    None for a book read back from its lengths (a container's), which
    therefore never speculates.  est_bpb, the expected bits a byte, picks
    api.encode's speculative capacity (api._cap_schedule).  The window
    fractions (_window_overflow_fracs) steer only the JAX package's
    speculative merge tree, which K1 does not have; they are kept equal to
    the JAX package's.
    """

    codes: np.ndarray      # (256,) uint32, right-aligned values
    lengths: np.ndarray    # (256,) int32
    max_len: int
    est_bpb: float | None = None
    est_w4_frac: float | None = None
    est_w8_frac: float | None = None
    est_w16_frac: float | None = None

    @staticmethod
    def from_frequencies(freqs: np.ndarray, max_code_len: int = 16) -> "Codebook":
        lengths = huffman_code_lengths(freqs)
        if lengths.max(initial=0) > max_code_len:
            lengths = package_merge_lengths(freqs, max_code_len)
        cb = Codebook.from_lengths(lengths)
        w4, w8, w16 = _window_overflow_fracs(freqs, lengths)
        return dataclasses.replace(
            cb, est_bpb=cb.expected_bits_per_byte(freqs),
            est_w4_frac=w4, est_w8_frac=w8, est_w16_frac=w16)

    @staticmethod
    def from_frequencies_auto(freqs: np.ndarray, max_code_len: int = 16,
                              narrow_tol: float = 0.01) -> "Codebook":
        """Prefer a cap-4 or cap-8 codebook when its expected size is within
        `narrow_tol` of the max_code_len one (the JAX package's policy; it
        keeps the two packages' codebooks, and so their streams, equal)."""
        full = Codebook.from_frequencies(freqs, max_code_len)
        if narrow_tol <= 0:
            return full
        base = full.expected_bits_per_byte(freqs)
        n_live = int(np.count_nonzero(freqs))
        for cap in (4, 8):
            if cap >= full.max_len or n_live > (1 << cap):
                continue
            narrow = Codebook.from_frequencies(freqs, cap)
            if narrow.expected_bits_per_byte(freqs) <= base * (1 + narrow_tol):
                return narrow
        return full

    @staticmethod
    def from_lengths(lengths: np.ndarray) -> "Codebook":
        """Rebuild from code lengths (container deserialization)."""
        lengths = np.asarray(lengths, dtype=np.int32)
        return Codebook(codes=canonical_codes(lengths), lengths=lengths,
                        max_len=int(lengths.max(initial=0)))

    @staticmethod
    def from_data(data, max_code_len: int = 16) -> "Codebook":
        return Codebook.from_frequencies(byte_histogram_host(data), max_code_len)

    def validate(self) -> None:
        """Raise ValueError unless the lengths form a prefix code."""
        ks = kraft_sum(self.lengths)
        if ks > 1.0 + 1e-12:
            raise ValueError(f"invalid codebook: Kraft sum {ks} > 1")

    def expected_bits_per_byte(self, freqs: np.ndarray) -> float:
        freqs = np.asarray(freqs, dtype=np.float64)
        total = freqs.sum()
        if total == 0:
            return 0.0
        return float((freqs * self.lengths).sum() / total)

    def decode_table(self, table_bits: int | None = None):
        """Single-level decode table: entry i holds the (symbol, length) of
        the code that prefixes the `table_bits`-bit value i.  Returns
        (syms[2**tb] uint8, lens[2**tb] uint8)."""
        tb = int(table_bits) if table_bits is not None else max(self.max_len, 1)
        if tb < self.max_len:
            raise ValueError("table_bits smaller than max code length")
        size = 1 << tb
        syms = np.zeros(size, dtype=np.uint8)
        lens = np.zeros(size, dtype=np.uint8)
        for s in range(NUM_SYMBOLS):
            L = int(self.lengths[s])
            if L == 0:
                continue
            base = int(self.codes[s]) << (tb - L)
            span = 1 << (tb - L)
            syms[base: base + span] = s
            lens[base: base + span] = L
        return syms, lens

    def canonical_decode_arrays(self):
        """(lim_b, off, perm, min_len) for arithmetic canonical decoding.

        len = min_len + sum_L [v > lim_b[L]] for a 32-bit MSB-aligned peek
        v, and sym = perm[(v >> (32 - len)) + off[len]].  lim_b is biased by
        0x80000000 into int32 (signed compares order the uint32 values);
        entries outside [min_len, max_len) are int32-max.  Same layout as
        the JAX package, which the wide-format reader consumes; codebooks
        with codes of 16 bits or more do not fit it.
        """
        lens = self.lengths.astype(np.int64)
        counts = np.bincount(lens[lens > 0], minlength=17)[:17]
        order = np.lexsort((np.arange(NUM_SYMBOLS), lens))
        live = order[lens[order] > 0]
        n_live = int(live.size)
        min_len = int(lens[live[0]]) if n_live else 1
        max_len = int(lens.max(initial=0))
        first = np.zeros(17, np.int64)     # canonical first code per length
        for L in range(1, 17):
            first[L] = (first[L - 1] + counts[L - 1]) << 1
        lim_b = np.full(16, np.int32(0x7FFFFFFF), np.int32)
        off = np.zeros(16, np.int32)
        cum = 0
        for L in range(1, max_len + 1):
            off[L] = np.int32(cum - first[L])
            cum += int(counts[L])
            if min_len <= L < max_len:
                bound = ((first[L] + counts[L]) << (32 - L)) - 1
                lim_b[L] = np.int32(np.uint32(bound) ^ np.uint32(1 << 31))
        pad = -(-max(n_live, 1) // 128) * 128
        perm = np.zeros(pad, np.int32)
        perm[:n_live] = live
        return lim_b, off, perm, min_len
