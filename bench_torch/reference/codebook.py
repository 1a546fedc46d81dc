"""The benchmark's own canonical Huffman codebook: the format's stated
rule, written out plainly in numpy.

Lengths: greedy two-minimum Huffman merges, ties broken by (count, then
the lowest symbol or the earliest merge); where a length passes the cap,
package-merge at the cap.  Codes: canonical, symbols ordered by (length,
value).  Cap policy: a cap-4 or cap-8 book is taken where its expected
size is within `narrow_tol` of the capped book's.  Absent symbols get
length 0.  Nothing here is read from the program under test.
"""

from __future__ import annotations

import heapq

import numpy as np

NUM_SYMBOLS = 256


def huffman_lengths(freqs: np.ndarray) -> np.ndarray:
    freqs = np.asarray(freqs, np.int64)
    live = np.flatnonzero(freqs)
    lengths = np.zeros(NUM_SYMBOLS, np.int32)
    if len(live) == 1:
        lengths[live[0]] = 1
    if len(live) <= 1:
        return lengths
    heap = [(int(freqs[s]), int(s), [int(s)]) for s in live]
    heapq.heapify(heap)
    order = NUM_SYMBOLS
    while len(heap) > 1:
        fa, _, a = heapq.heappop(heap)
        fb, _, b = heapq.heappop(heap)
        lengths[a + b] += 1
        heapq.heappush(heap, (fa + fb, order, a + b))
        order += 1
    return lengths


def package_merge_lengths(freqs: np.ndarray, cap: int) -> np.ndarray:
    freqs = np.asarray(freqs, np.int64)
    live = np.flatnonzero(freqs)
    lengths = np.zeros(NUM_SYMBOLS, np.int32)
    if len(live) == 1:
        lengths[live[0]] = 1
    if len(live) <= 1:
        return lengths
    if len(live) > 1 << cap:
        raise ValueError(f"{len(live)} symbols do not fit {cap}-bit codes")
    leaves = sorted((int(freqs[s]), (int(s),)) for s in live)
    items = list(leaves)
    for _ in range(cap - 1):
        pairs = [(items[i][0] + items[i + 1][0], items[i][1] + items[i + 1][1])
                 for i in range(0, len(items) - 1, 2)]
        items = sorted(leaves + pairs)
    for _, syms in items[: 2 * len(live) - 2]:
        for s in syms:
            lengths[s] += 1
    return lengths


def capped_lengths(freqs: np.ndarray, cap: int) -> np.ndarray:
    lengths = huffman_lengths(freqs)
    if lengths.max(initial=0) > cap:
        lengths = package_merge_lengths(freqs, cap)
    return lengths


def mean_bits(freqs: np.ndarray, lengths: np.ndarray) -> float:
    f = np.asarray(freqs, np.float64)
    return float((f * lengths).sum() / f.sum()) if f.sum() else 0.0


def code_lengths(freqs: np.ndarray, cap: int, narrow_tol: float) -> np.ndarray:
    """The (256,) int32 code lengths the format's rule gives `freqs`."""
    full = capped_lengths(freqs, cap)
    if narrow_tol <= 0:
        return full
    base = mean_bits(freqs, full)
    n_live = int(np.count_nonzero(freqs))
    for narrow_cap in (4, 8):
        if narrow_cap >= full.max(initial=0) or n_live > 1 << narrow_cap:
            continue
        narrow = capped_lengths(freqs, narrow_cap)
        if mean_bits(freqs, narrow) <= base * (1 + narrow_tol):
            return narrow
    return full


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """(256,) int64 right-aligned canonical code values."""
    codes = np.zeros(NUM_SYMBOLS, np.int64)
    code, prev = 0, 0
    for s in np.lexsort((np.arange(NUM_SYMBOLS), lengths)):
        length = int(lengths[s])
        if length == 0:
            continue
        if prev:
            code <<= length - prev
        codes[s] = code
        code += 1
        prev = length
    return codes


def decode_table(lengths: np.ndarray, table_bits: int):
    """(symbols, lengths) of every table_bits-bit prefix, int64 each."""
    codes = canonical_codes(lengths)
    syms = np.zeros(1 << table_bits, np.int64)
    lens = np.zeros(1 << table_bits, np.int64)
    for s in np.flatnonzero(lengths):
        length = int(lengths[s])
        lo = int(codes[s]) << (table_bits - length)
        syms[lo: lo + (1 << (table_bits - length))] = s
        lens[lo: lo + (1 << (table_bits - length))] = length
    return syms, lens
