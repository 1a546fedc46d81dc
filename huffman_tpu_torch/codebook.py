"""Canonical Huffman codebook construction (host side, numpy).

Counterpart of huffman_tpu/codebook.py: the same greedy Huffman lengths,
the same package-merge length cap, the same canonical code assignment and
the same narrow-cap policy, so both packages give identical `lengths` and
`codes` for the same histogram, and the same speculation estimates
(est_bpb and the window-overflow fractions est_w*_frac).
"""

from __future__ import annotations

import dataclasses
from bisect import bisect_right
from itertools import accumulate, groupby, repeat
from operator import add, and_, lshift, or_

import numpy as np

from .config import NUM_SYMBOLS
from .utils.timing import Counter

# Codebooks finished from a histogram (Codebook._finish): one a build.
finished = Counter()


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
    return _Lengths(freqs).free()


def package_merge_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Optimal code lengths subject to length <= max_len (package-merge)."""
    return _Lengths(freqs).merged(max_len)


class _Lengths:
    """The code lengths of one histogram of counts: the unrestricted
    Huffman ones (free) and package-merge's at a cap (merged), both from
    one sort of the live symbols by (count, symbol).  Each is made once:
    the merge, and package-merge's levels, which a run to cap L shares
    with every smaller cap."""

    def __init__(self, freqs: np.ndarray):
        freqs = np.asarray(freqs, dtype=np.int64)
        syms = np.flatnonzero(freqs)
        self.leaves = syms[np.argsort(freqs[syms], kind="stable")]
        self.counts = freqs[self.leaves].tolist()
        self.n = len(self.counts)
        self._free = self.free_max = None
        self._levels = None

    def _lengths(self, of_leaves) -> np.ndarray:
        lengths = np.zeros(NUM_SYMBOLS, dtype=np.int32)
        lengths[self.leaves] = of_leaves
        return lengths

    def free(self) -> np.ndarray:
        """The JAX package pops a heap of (count, tiebreak), where a leaf
        breaks ties by its symbol and the k-th merged node by NUM_SYMBOLS
        + k.  The same order comes off two queues: the leaves in (count,
        symbol) order, and the merged nodes in the order they are made,
        whose counts never fall; on equal counts the leaf goes first.
        Each node keeps its parent, and a leaf's length is its depth."""
        if self._free is not None:
            return self._free
        n = self.n
        if n <= 1:
            self.free_max = n
            self._free = self._lengths(1)
            return self._free
        end = sum(self.counts) + 1          # past every count: an empty queue
        leaf_w = self.counts + [end]
        node_w = [end] * n                 # merged node k is node n + k
        parent = [0] * (2 * n - 1)
        i = j = 0
        for k in range(n, 2 * n - 1):
            if leaf_w[i] <= node_w[j]:
                parent[i], w = k, leaf_w[i]
                i += 1
            else:
                parent[n + j], w = k, node_w[j]
                j += 1
            if leaf_w[i] <= node_w[j]:
                parent[i], w = k, w + leaf_w[i]
                i += 1
            else:
                parent[n + j], w = k, w + node_w[j]
                j += 1
            node_w[k - n] = w
        depth = [0] * (2 * n - 1)
        for v in range(2 * n - 3, -1, -1):
            depth[v] = depth[parent[v]] + 1
        self.free_max = max(depth[:n])
        self._free = self._lengths(depth[:n])
        return self._free

    def merged(self, cap: int) -> np.ndarray:
        """The JAX package sorts items of (weight, symbol tuple) at each
        level, a package joining two neighbours' tuples, and a symbol's
        length is the number of times it occurs in the first 2n - 2 items
        at the cap.  Counts are positive, so of two items of equal weight
        neither tuple is a proper prefix of the other: equal weights are
        ordered by the tuples' first symbols, and packages, which come
        sorted, keep the order they are made in.  So an item is the int
        (weight << 8) | first symbol, and a level is sorted(leaves +
        packages), which is stable.  The first x items of a level hold a
        prefix of the leaves and of the packages, and its packages are
        made of the first 2 * packages items one level down: the lengths
        are read walking down from x = 2n - 2."""
        n = self.n
        if n <= 1:
            return self._lengths(1)
        if n > (1 << cap):
            raise ValueError(f"cannot code {n} symbols with max length {cap}")
        if self._levels is None:
            self._levels = [list(map(or_, map(lshift, self.counts, repeat(8)),
                                     self.leaves.tolist()))]
        keys, levels = self._levels[0], self._levels
        while len(levels) < cap:
            up = levels[-1]
            up = keys + list(map(add, up[0::2],
                                 map(and_, up[1::2], repeat(-256))))
            up.sort()
            levels.append(up)
        x, taken = 2 * n - 2, [0] * (n + 1)
        for level in reversed(levels[:cap]):
            leaves = bisect_right(keys, level[x - 1]) if x else 0
            taken[leaves] += 1
            x = 2 * (x - leaves)
        # leaf i's length: the levels that take more than i leaves
        return self._lengths(list(accumulate(taken[:0:-1]))[::-1])

    def capped(self, cap: int) -> np.ndarray:
        """The lengths at most `cap` long: the unrestricted ones where they
        fit, else package-merge's."""
        free = self.free()
        return self.merged(cap) if self.free_max > cap else free


def kraft_sum(lengths: np.ndarray) -> float:
    """Sum of 2**-L over the present symbols: at most 1 for a prefix code."""
    nz = np.asarray(lengths)
    nz = nz[nz > 0].astype(np.float64)
    return float(np.sum(2.0 ** (-nz)))


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical right-aligned code values: symbols ordered by (length,
    value), codes counting up and left-shifted when the length grows.
    Each run of one length counts up from its first code; raises
    OverflowError where a code does not fit 32 bits."""
    lengths = np.asarray(lengths, dtype=np.int32)
    codes = np.zeros(NUM_SYMBOLS, dtype=np.uint32)
    order = np.argsort(lengths, kind="stable")       # (length, symbol)
    order = order[lengths[order] != 0]
    base, runs, code, at, prev = [], [], 0, 0, None
    for length, run in groupby(lengths[order].tolist()):
        if prev is not None:
            code <<= length - prev
        k = len(list(run))
        base.append(code - at)        # the run's codes: base + position
        runs.append(k)
        code, at, prev = code + k, at + k, length
    if code - 1 > 0xFFFFFFFF:
        raise OverflowError(f"canonical code {code - 1} does not fit 32 bits")
    codes[order] = np.repeat(base, runs) + np.arange(at)
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
    pmf = np.bincount(lengths, weights=f / tot)
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


def _mean_bits(freqs: np.ndarray, lengths: np.ndarray) -> float:
    """Expected bits a byte of `freqs` under `lengths`."""
    freqs = np.asarray(freqs, dtype=np.float64)
    total = freqs.sum()
    if total == 0:
        return 0.0
    return float((freqs * lengths).sum() / total)


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
        lengths = _Lengths(freqs).capped(max_code_len)
        return Codebook._finish(freqs, lengths, _mean_bits(freqs, lengths))

    @staticmethod
    def from_frequencies_auto(freqs: np.ndarray, max_code_len: int = 16,
                              narrow_tol: float = 0.01) -> "Codebook":
        """Prefer a cap-4 or cap-8 codebook when its expected size is within
        `narrow_tol` of the max_code_len one (the JAX package's policy; it
        keeps the two packages' codebooks, and so their streams, equal)."""
        return auto_book(freqs, max_code_len, narrow_tol)[0]

    @staticmethod
    def _finish(freqs: np.ndarray, lengths: np.ndarray,
                bits: float) -> "Codebook":
        """The codebook of `lengths` with the estimates of `freqs`, `bits`
        its expected bits a byte (_mean_bits)."""
        finished.n += 1
        w4, w8, w16 = _window_overflow_fracs(freqs, lengths)
        return Codebook(codes=canonical_codes(lengths), lengths=lengths,
                        max_len=int(lengths.max(initial=0)), est_bpb=bits,
                        est_w4_frac=w4, est_w8_frac=w8, est_w16_frac=w16)

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
        return _mean_bits(freqs, self.lengths)

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


def auto_book(freqs: np.ndarray, max_code_len: int = 16,
              narrow_tol: float = 0.01) -> tuple[Codebook, tuple[int, ...]]:
    """Codebook.from_frequencies_auto's codebook, and the caps whose
    lengths it priced (max_code_len first).  One unrestricted merge serves
    every cap; a narrow candidate is priced by its expected bits a byte
    from its lengths alone, and only the chosen lengths become a
    Codebook."""
    made, f = _Lengths(freqs), np.asarray(freqs, dtype=np.float64)
    lengths = made.capped(max_code_len)
    bits, caps = _mean_bits(f, lengths), [max_code_len]
    if narrow_tol > 0:
        max_len = int(lengths.max(initial=0))
        for cap in (4, 8):
            if cap >= max_len or made.n > (1 << cap):
                continue
            caps.append(cap)
            narrow = made.capped(cap)
            narrow_bits = _mean_bits(f, narrow)
            if narrow_bits <= bits * (1 + narrow_tol):
                lengths, bits = narrow, narrow_bits
                break
    return Codebook._finish(f, lengths, bits), tuple(caps)
