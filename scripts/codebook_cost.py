#!/usr/bin/env python3
"""The host's codebook build (Codebook.from_frequencies_auto) on the
benchmark's two card histograms, against the build it replaced.

Run from the repository root, on any host (no card is used):

    python3 scripts/codebook_cost.py [--reps R] [--seed N] [--out FILE]

The histograms are drawn on the host from the seed, at the cells' own
sizes, from the traffic files' distributions (bench_torch/traffic):

  pavle-1g        1 GiB of the 32-symbol geometric profile at H = 2.2066
                  bits a byte (pavle-1g.json);
  bf16-exponents  the exponent bytes of nemotron-h-47b-mlp-bf16.json's
                  bf16 weights: each tensor's elements fall in a binade
                  with the normal law's probability, the binade's edges
                  moved down by the rounding to 8 significant bits.

For each, the build is timed R times (default 400), the program's and the
replaced one's in turns, on the host clock (time.perf_counter); the
replaced build is a copy of the earlier functions held in this script
(PARENT_*: a heap of Python lists, package-merge on tuples of symbol
tuples, a code loop, and the narrow candidate built as a whole second
book).  The two books are held equal field by field.  Prints one JSON
line (each build's median and quartiles in ms, their ratio, the caps the
program priced and the books it finished), written to FILE too where
given; exits 1 where a book differs.
"""

from __future__ import annotations

import argparse
import dataclasses
import heapq
import json
import math
import platform
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
NUM_SYMBOLS = 256


# ---- the replaced build, as it was ----

def PARENT_huffman_code_lengths(freqs):
    freqs = np.asarray(freqs, dtype=np.int64)
    syms = np.flatnonzero(freqs)
    lengths = np.zeros(NUM_SYMBOLS, dtype=np.int32)
    if len(syms) == 0:
        return lengths
    if len(syms) == 1:
        lengths[syms[0]] = 1
        return lengths
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


def PARENT_package_merge_lengths(freqs, max_len):
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


def PARENT_canonical_codes(lengths):
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


def PARENT_window_overflow_fracs(freqs, lengths):
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
class PARENT_Codebook:
    codes: np.ndarray
    lengths: np.ndarray
    max_len: int
    est_bpb: float | None = None
    est_w4_frac: float | None = None
    est_w8_frac: float | None = None
    est_w16_frac: float | None = None

    @staticmethod
    def from_frequencies(freqs, max_code_len=16):
        lengths = PARENT_huffman_code_lengths(freqs)
        if lengths.max(initial=0) > max_code_len:
            lengths = PARENT_package_merge_lengths(freqs, max_code_len)
        lengths = np.asarray(lengths, dtype=np.int32)
        cb = PARENT_Codebook(codes=PARENT_canonical_codes(lengths),
                             lengths=lengths,
                             max_len=int(lengths.max(initial=0)))
        w4, w8, w16 = PARENT_window_overflow_fracs(freqs, lengths)
        return dataclasses.replace(
            cb, est_bpb=cb.expected_bits_per_byte(freqs),
            est_w4_frac=w4, est_w8_frac=w8, est_w16_frac=w16)

    @staticmethod
    def from_frequencies_auto(freqs, max_code_len=16, narrow_tol=0.01):
        full = PARENT_Codebook.from_frequencies(freqs, max_code_len)
        if narrow_tol <= 0:
            return full
        base = full.expected_bits_per_byte(freqs)
        n_live = int(np.count_nonzero(freqs))
        for cap in (4, 8):
            if cap >= full.max_len or n_live > (1 << cap):
                continue
            narrow = PARENT_Codebook.from_frequencies(freqs, cap)
            if narrow.expected_bits_per_byte(freqs) <= base * (1 + narrow_tol):
                return narrow
        return full

    def expected_bits_per_byte(self, freqs):
        freqs = np.asarray(freqs, dtype=np.float64)
        total = freqs.sum()
        if total == 0:
            return 0.0
        return float((freqs * self.lengths).sum() / total)


# ---- the histograms ----

def _traffic(name: str) -> dict:
    return json.loads((ROOT / "bench_torch" / "traffic" / f"{name}.json")
                      .read_text())


def pavle_freqs(rng) -> np.ndarray:
    from huffman_tpu_torch.utils import testdata
    t = _traffic("pavle-1g")
    p = testdata.geometric_probs(
        t["symbols"], testdata.decay_for_entropy(t["entropy_bits_per_byte"],
                                                 t["symbols"]))
    f = np.zeros(NUM_SYMBOLS, np.int64)
    f[: t["symbols"]] = rng.multinomial(int(t["bytes"]), p)
    return f


def bf16_exponent_freqs(rng) -> np.ndarray:
    """Exponent byte e holds |w| in [2^(e-127), 2^(e-126)) after rounding
    to bf16's 8 significant bits, which carries |w| from 2^k (1 - 2^-9)
    up to 2^k; zero and subnormals are not drawn at these deviations."""
    t = _traffic("nemotron-h-47b-mlp-bf16")
    n = int(t["bytes"]) // 2
    sizes = [math.prod(x["shape"]) for x in t["tensors"]]
    counts = [s * n // sum(sizes) for s in sizes[:-1]]
    counts.append(n - sum(counts))
    edges = [2.0 ** (e - 127) * (1 - 2.0 ** -9) for e in range(1, 256)]
    f = np.zeros(NUM_SYMBOLS, np.int64)
    for x, count in zip(t["tensors"], counts):
        std = x["std"] / math.sqrt(x.get("std_divisor_sqrt", 1))
        below = [math.erf(b / (std * math.sqrt(2))) for b in edges]
        p = np.diff([0.0] + below + [1.0])      # exponents 0 .. 255
        f += rng.multinomial(count, p / p.sum())
    return f


# ---- the timing ----

def _same(a, b) -> bool:
    return (np.array_equal(a.lengths, b.lengths)
            and np.array_equal(a.codes, b.codes)
            and a.lengths.dtype == b.lengths.dtype
            and a.codes.dtype == b.codes.dtype
            and all(getattr(a, k) == getattr(b, k) for k in (
                "max_len", "est_bpb", "est_w4_frac", "est_w8_frac",
                "est_w16_frac")))


def _summary(seconds: list[float]) -> dict:
    q1, q2, q3 = statistics.quantiles(seconds, n=4)
    return {"median_ms": 1e3 * q2, "q1_ms": 1e3 * q1, "q3_ms": 1e3 * q3}


def measure(freqs, reps: int, max_code_len: int, narrow_tol: float) -> dict:
    from huffman_tpu_torch import codebook
    new = codebook.Codebook.from_frequencies_auto
    old = PARENT_Codebook.from_frequencies_auto
    for _ in range(5):
        new(freqs, max_code_len, narrow_tol)
        old(freqs, max_code_len, narrow_tol)
    t_new, t_old = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        book = new(freqs, max_code_len, narrow_tol)
        t1 = time.perf_counter()
        parent = old(freqs, max_code_len, narrow_tol)
        t2 = time.perf_counter()
        t_new.append(t1 - t0)
        t_old.append(t2 - t1)
    before = codebook.finished.n
    _, caps = codebook.auto_book(freqs, max_code_len, narrow_tol)
    new_s, old_s = _summary(t_new), _summary(t_old)
    return {"live_symbols": int(np.count_nonzero(freqs)),
            "max_len": book.max_len, "est_bpb": book.est_bpb,
            "caps": list(caps), "books": codebook.finished.n - before,
            "build": new_s, "replaced": old_s,
            "speedup": old_s["median_ms"] / new_s["median_ms"],
            "same_book": _same(book, parent)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=400)
    p.add_argument("--seed", type=int, default=2026)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from huffman_tpu_torch.config import DEFAULT_CONFIG as cfg
    rng = np.random.default_rng(args.seed)
    result = {"host": platform.processor() or platform.machine(),
              "python": platform.python_version(),
              "numpy": np.__version__, "reps": args.reps, "seed": args.seed,
              "max_code_len": cfg.max_code_len,
              "narrow_tol": cfg.narrow_tol}
    for name, make in (("pavle-1g", pavle_freqs),
                       ("bf16-exponents", bf16_exponent_freqs)):
        result[name] = measure(make(rng), args.reps, cfg.max_code_len,
                               cfg.narrow_tol)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0 if all(result[k]["same_book"]
                    for k in ("pavle-1g", "bf16-exponents")) else 1


if __name__ == "__main__":
    sys.exit(main())
