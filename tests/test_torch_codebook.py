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
