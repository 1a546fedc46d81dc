"""The port's codebook (huffman_tpu_torch.codebook) against huffman_tpu's.

Same histograms in, identical lengths, codes, decode tables, canonical
decode arrays and narrow-cap choices out (tolerance zero: integer data),
over the cases of tests/test_codebook.py.
"""

import numpy as np
import pytest

from huffman_tpu import codebook as ref
from huffman_tpu.utils import testdata as ref_testdata
from huffman_tpu_torch import codebook as port
from huffman_tpu_torch.utils import testdata


def _freqs(kind: str) -> np.ndarray:
    f = np.zeros(256, dtype=np.int64)
    if kind == "two":
        f[65], f[66] = 10, 1
    elif kind == "single":
        f[7] = 100
    elif kind == "empty":
        pass
    elif kind == "random64":
        f[:64] = np.random.default_rng(3).integers(1, 10_000, 64)
    elif kind == "dyadic":
        f[:4] = [1, 1, 2, 4]
    elif kind == "fibonacci":           # deep unrestricted tree (> 16 bits)
        a, b = 1, 1
        for i in range(30):
            f[i] = a
            a, b = b, a + b
    elif kind == "pareto100":
        rng = np.random.default_rng(12)
        f[:100] = (rng.pareto(0.3, 100) * 100 + 1).astype(np.int64)
    elif kind == "skewed32":
        f = port.byte_histogram_host(testdata.skewed(100_000, seed=5))
    elif kind == "uniform16":
        f[:16] = 1000
    elif kind == "zipf256":             # every symbol live
        rng = np.random.default_rng(1)
        f = port.byte_histogram_host(rng.zipf(1.3, size=1 << 16)
                                     .astype(np.uint8)) + 1
    elif kind == "log2_18":             # cap-8 costs ~2.9% expected size
        raw = np.random.default_rng(0).integers(1, 1 << 30, size=1 << 16,
                                                dtype=np.int64)
        f = port.byte_histogram_host(
            (np.log2(raw).astype(np.int32) % 32).astype(np.uint8))
    elif kind == "full_tree8":
        f[:8] = [8, 4, 2, 1, 1, 1, 1, 1]
    return f


KINDS = ["two", "single", "empty", "random64", "dyadic", "fibonacci",
         "pareto100", "skewed32", "uniform16", "zipf256", "log2_18",
         "full_tree8"]


@pytest.mark.parametrize("kind", KINDS)
def test_huffman_lengths_equal(kind):
    f = _freqs(kind)
    np.testing.assert_array_equal(port.huffman_code_lengths(f),
                                  ref.huffman_code_lengths(f))


@pytest.mark.parametrize("kind,cap", [("fibonacci", 16), ("fibonacci", 12),
                                      ("pareto100", 8), ("pareto100", 10),
                                      ("random64", 32), ("zipf256", 9),
                                      ("two", 4)])
def test_package_merge_equal(kind, cap):
    f = _freqs(kind)
    np.testing.assert_array_equal(port.package_merge_lengths(f, cap),
                                  ref.package_merge_lengths(f, cap))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("max_code_len", [8, 12, 16])
def test_from_frequencies_equal(kind, max_code_len):
    f = _freqs(kind)
    a = port.Codebook.from_frequencies(f, max_code_len)
    b = ref.Codebook.from_frequencies(f, max_code_len)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_array_equal(a.codes, b.codes)
    assert a.max_len == b.max_len
    assert a.expected_bits_per_byte(f) == b.expected_bits_per_byte(f)


@pytest.mark.parametrize("kind", ["log2_18", "uniform16", "zipf256",
                                  "skewed32", "random64", "single"])
@pytest.mark.parametrize("tol", [0.0, 0.01, 0.05])
def test_narrow_policy_equal(kind, tol):
    f = _freqs(kind)
    a = port.Codebook.from_frequencies_auto(f, 12, narrow_tol=tol)
    b = ref.Codebook.from_frequencies_auto(f, 12, narrow_tol=tol)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_array_equal(a.codes, b.codes)
    assert a.max_len == b.max_len


@pytest.mark.parametrize("kind", ["two", "single", "dyadic", "skewed32",
                                  "uniform16", "full_tree8", "random64"])
def test_decode_tables_equal(kind):
    f = _freqs(kind)
    a = port.Codebook.from_frequencies(f, 12)
    b = ref.Codebook.from_frequencies(f, 12)
    for tb in (None, a.max_len + 2):
        for x, y in zip(a.decode_table(tb), b.decode_table(tb)):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(a.canonical_decode_arrays(), b.canonical_decode_arrays()):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_from_lengths_and_histogram_equal(seed):
    data = testdata.skewed(20_000, num_symbols=48, seed=seed)
    np.testing.assert_array_equal(port.byte_histogram_host(data),
                                  ref.byte_histogram_host(data))
    f = port.byte_histogram_host(data)
    assert port.entropy_bits_per_byte(f) == ref.entropy_bits_per_byte(f)
    lens = ref.Codebook.from_frequencies(f, 12).lengths
    a, b = port.Codebook.from_lengths(lens), ref.Codebook.from_lengths(lens)
    np.testing.assert_array_equal(a.codes, b.codes)
    assert a.max_len == b.max_len


@pytest.mark.parametrize("gen,kwargs", [
    ("skewed", {"n": 5000, "num_symbols": 32, "seed": 4}),
    ("uniform_random", {"n": 5000, "num_symbols": 16, "seed": 2}),
    ("skewed", {"n": 3000, "num_symbols": 256, "decay": 0.97, "seed": 9}),
])
def test_testdata_same_bytes(gen, kwargs):
    np.testing.assert_array_equal(getattr(testdata, gen)(**kwargs),
                                  getattr(ref_testdata, gen)(**kwargs))


def test_entropy_stream_profile():
    """The chunked GiB-scale generator: exact distribution entropy by
    bisection, 32 symbols, draws chunk by chunk from one generator."""
    d = testdata.decay_for_entropy()
    h = port.entropy_bits_per_byte(testdata.geometric_probs(32, d))
    assert abs(h - testdata.FIXTURE_ENTROPY) < 1e-9
    a = testdata.entropy_stream(1 << 16, seed=5, chunk=1 << 12)
    assert np.array_equal(a, testdata.entropy_stream(1 << 16, seed=5,
                                                     chunk=1 << 12))
    assert a.max() < 32
    measured = port.entropy_bits_per_byte(port.byte_histogram_host(a))
    assert abs(measured - testdata.FIXTURE_ENTROPY) < 2e-2


# The build of one codebook a call (codebook.auto_book): one unrestricted
# merge shared by every cap, narrow candidates priced from their lengths,
# the merges on ints.  Its books are held to the JAX package's, field by
# field, on seeded histograms made to tie: few distinct counts, all equal,
# powers of two, Fibonacci, pair sums that hit leaves, and plain ones.

FAMILIES = ["few_counts", "all_equal", "dyadic", "fibonacci", "sums",
            "geometric", "wide_counts", "pareto"]
SEEDS_PER_FAMILY = 30
CAPS = [4, 8, 12, 16]
TOLS = [0.0, 0.01, 0.05]


def _fibonacci(k: int) -> np.ndarray:
    fib = [1, 1]
    while len(fib) < 60:
        fib.append(fib[-1] + fib[-2])
    return np.array([fib[i % 60] for i in range(k)], np.int64)


def _random_freqs(family: str, seed: int) -> np.ndarray:
    """A histogram of 1 to 256 live symbols at random places; the first
    three seeds of a family hold 1, 2 and 256 symbols."""
    rng = np.random.default_rng([FAMILIES.index(family), seed])
    k = (1, 2, 256)[seed] if seed < 3 else int(rng.integers(1, 257))
    syms = rng.choice(256, k, replace=False)
    f = np.zeros(256, np.int64)
    f[syms] = {
        "few_counts": lambda: rng.integers(1, 4, k),
        "all_equal": lambda: np.full(k, rng.integers(1, 1000)),
        "dyadic": lambda: 2 ** rng.integers(0, 24, k),
        "fibonacci": lambda: _fibonacci(k),
        "sums": lambda: rng.choice([1, 2, 3, 4, 5, 6, 8, 10, 12, 16], k),
        "geometric": lambda: rng.geometric(rng.uniform(0.01, 0.9), k),
        "wide_counts": lambda: rng.integers(1, 1 << 40, k),
        "pareto": lambda: (rng.pareto(0.3, k) * 100 + 1).astype(np.int64),
    }[family]()
    return f


def _pavle_freqs() -> np.ndarray:
    """pavle-1g's histogram: 1 GiB of the 32-symbol geometric profile."""
    p = testdata.geometric_probs(32, testdata.decay_for_entropy())
    f = np.zeros(256, np.int64)
    f[:32] = np.random.default_rng(1).multinomial(1 << 30, p)
    return f


def _bf16_exponent_freqs() -> np.ndarray:
    """The exponent bytes of bf16 weights, half N(0, 0.02^2) and half
    N(0, 0.02^2 / 98): a Nemotron-H MLP block's up and down projections."""
    import torch
    rng = np.random.default_rng(2)
    w = np.concatenate([rng.normal(0, 0.02, 1 << 21),
                        rng.normal(0, 0.02 / np.sqrt(98), 1 << 21)])
    bits = (torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16)
            .view(torch.int16).numpy().view(np.uint16))
    return np.bincount((bits >> 7) & 0xFF, minlength=256).astype(np.int64)


def _assert_same_book(a, b):
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_array_equal(a.codes, b.codes)
    assert a.lengths.dtype == b.lengths.dtype
    assert a.codes.dtype == b.codes.dtype
    for field in ("max_len", "est_bpb", "est_w4_frac", "est_w8_frac",
                  "est_w16_frac"):
        assert getattr(a, field) == getattr(b, field), field


def _auto_books(f, cap, tol):
    """(port's, JAX package's) from_frequencies_auto, or both ValueError."""
    try:
        want = ref.Codebook.from_frequencies_auto(f, cap, narrow_tol=tol)
    except ValueError:
        with pytest.raises(ValueError):
            port.Codebook.from_frequencies_auto(f, cap, narrow_tol=tol)
        return None
    return port.Codebook.from_frequencies_auto(f, cap, narrow_tol=tol), want


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("family", FAMILIES)
def test_one_build_equals_the_jax_book(family, cap):
    for seed in range(SEEDS_PER_FAMILY):
        f = _random_freqs(family, seed)
        for tol in TOLS:
            books = _auto_books(f, cap, tol)
            if books is not None:
                _assert_same_book(*books)


@pytest.mark.parametrize("tol", TOLS)
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("profile", ["pavle-1g", "bf16-exponents"])
def test_one_build_equals_the_jax_book_on_the_cells(profile, cap, tol):
    f = _pavle_freqs() if profile == "pavle-1g" else _bf16_exponent_freqs()
    assert np.count_nonzero(f) >= (32 if profile == "pavle-1g" else 24)
    books = _auto_books(f, cap, tol)
    if cap == 4:                    # more than 16 symbols: refused by both
        assert books is None
        return
    _assert_same_book(*books)
    # the book priced alone: its caps, the capped one first
    book, caps = port.auto_book(f, cap, tol)
    _assert_same_book(book, port.Codebook.from_frequencies_auto(f, cap, tol))
    assert caps[0] == cap and set(caps[1:]) <= {4, 8}


def test_one_build_finishes_one_book():
    """pavle-1g's narrow cap-8 candidate is priced and refused: one book
    is finished where the JAX package builds two."""
    before = port.finished.n
    book, caps = port.auto_book(_pavle_freqs(), 12, 0.01)
    assert port.finished.n - before == 1
    assert caps == (12, 8) and book.max_len == 12


@pytest.mark.parametrize("family", FAMILIES)
def test_rewritten_merges_equal_the_jax_ones(family):
    """huffman_code_lengths, package_merge_lengths at every cap that holds
    the symbols, and canonical_codes of the results, against the JAX
    package's functions on the same inputs."""
    for seed in range(SEEDS_PER_FAMILY):
        f = _random_freqs(family, seed)
        free = port.huffman_code_lengths(f)
        np.testing.assert_array_equal(free, ref.huffman_code_lengths(f))
        _assert_same_codes(free)
        for cap in range(1, 17):
            if np.count_nonzero(f) > 1 << cap:
                with pytest.raises(ValueError):
                    port.package_merge_lengths(f, cap)
                continue
            got = port.package_merge_lengths(f, cap)
            np.testing.assert_array_equal(got,
                                          ref.package_merge_lengths(f, cap))
            _assert_same_codes(got)


def _codes_or_error(fn, lengths):
    try:
        return fn(lengths)
    except OverflowError:
        return OverflowError


def _assert_same_codes(lengths):
    got = _codes_or_error(port.canonical_codes, lengths)
    want = _codes_or_error(ref.canonical_codes, lengths)
    if want is OverflowError:
        assert got is OverflowError, lengths
    else:
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("seed", range(6))
def test_canonical_codes_equal_on_any_lengths(seed):
    """Any lengths, a prefix code or not, a container's bytes among them:
    the same codes, or OverflowError where a code passes 32 bits."""
    rng = np.random.default_rng(seed)
    cases = [np.zeros(256, np.int32), np.r_[40, np.zeros(255, np.int32)],
             np.r_[33, 33, np.zeros(254, np.int32)],
             np.r_[1, 40, np.zeros(254, np.int32)],
             np.r_[-3, 2, 5, np.zeros(253, np.int32)],
             np.full(256, 8, np.int32), np.full(256, 255, np.int32)]
    top = (4, 12, 24, 33, 64, 256)[seed]
    cases += [rng.integers(0, top, 256) * (rng.random(256) < rng.random())
              for _ in range(200)]
    for lengths in cases:
        _assert_same_codes(np.asarray(lengths, np.int32))
