"""The port's golden codec, numpy bit codec, test data, small ops helpers
and codebook estimates, against huffman_tpu's.

golden.decode and golden.histogram (the port's copy of the C++ oracle),
numpy_codec.encode_bits / decode_bits, testdata.rle_runs, dummy_codebook
and entropy_fixture, ops.scan.total_bits_host and block_bit_ends,
ops.encode.overflowed, ops.pack.pack_reference, and Codebook.est_*:
each against the JAX package's function on the same inputs.  Exact
equality, except the estimates (floats from the same formulas, held to
rtol 1e-12).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from huffman_tpu import golden as ref_golden
from huffman_tpu.codebook import Codebook as RefCodebook
from huffman_tpu.golden import numpy_codec as ref_nc
from huffman_tpu.ops import encode as ref_encode_ops
from huffman_tpu.ops import pack as ref_pack_ops
from huffman_tpu.ops import scan as ref_scan
from huffman_tpu.utils import testdata as ref_testdata

from huffman_tpu_torch import golden
from huffman_tpu_torch.codebook import Codebook
from huffman_tpu_torch.golden import numpy_codec as nc
from huffman_tpu_torch.ops import encode as encode_ops
from huffman_tpu_torch.ops import pack as pack_ops
from huffman_tpu_torch.ops import scan
from huffman_tpu_torch.utils import testdata

SEEDS = (0, 5, 17)


def _books(data):
    """The port's and the JAX package's codebook of data (equal lengths)."""
    freqs = np.bincount(data, minlength=256)
    return (Codebook.from_frequencies(freqs, 12),
            RefCodebook.from_frequencies(freqs, 12))


def _shifted(stream: np.ndarray, total_bits: int, k: int, seed: int):
    """stream with k random bits put in front of it."""
    bits = np.unpackbits(stream)[:total_bits]
    lead = np.random.default_rng(seed).integers(0, 2, k).astype(np.uint8)
    return np.packbits(np.concatenate([lead, bits]))


@pytest.mark.parametrize("seed", SEEDS)
def test_golden_decode_equals_reference(seed):
    data = testdata.skewed(5000 + seed, num_symbols=24, seed=seed)
    cb, ref_cb = _books(data)
    stream, total = golden.encode(data, cb)
    ends = np.cumsum(cb.lengths[data].astype(np.int64))
    mid = int(ends[2999])                    # after symbol 3000
    for s, off, want in ((stream, 0, data),
                         (_shifted(stream, total, 13, seed), 13, data),
                         (stream, mid, data[3000:])):
        out = golden.decode(s, want.size, cb, off)
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(
            out, ref_golden.decode(s, want.size, ref_cb, off))


def test_golden_decode_corrupt_raises():
    lens = np.zeros(256, np.int32)
    lens[:2] = [1, 2]                        # codes 0 and 10: 11 is no code
    cb, ref_cb = Codebook.from_lengths(lens), RefCodebook.from_lengths(lens)
    ones = np.full(16, 0xFF, np.uint8)
    with pytest.raises(ValueError, match="corrupt"):
        golden.decode(ones, 10, cb)
    with pytest.raises(ValueError, match="corrupt"):
        ref_golden.decode(ones, 10, ref_cb)
    assert golden.decode(ones, 0, cb).size == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_golden_histogram_equals_reference(seed):
    data = testdata.uniform_random(10_000 + 7 * seed, seed=seed)
    h = golden.histogram(data)
    assert h.dtype == np.int64
    np.testing.assert_array_equal(h, ref_golden.histogram(data))
    np.testing.assert_array_equal(h, np.bincount(data, minlength=256))
    np.testing.assert_array_equal(golden.histogram(b""), np.zeros(256))


@pytest.mark.parametrize("seed", SEEDS)
def test_numpy_bit_codec_equals_reference_and_golden(seed):
    data = testdata.skewed(3000 + seed, num_symbols=40, decay=0.85,
                           seed=seed)
    cb, ref_cb = _books(data)
    packed, total = nc.encode_bits(data, cb)
    ref_packed, ref_total = ref_nc.encode_bits(data, ref_cb)
    g_packed, g_total = golden.encode(data, cb)
    assert total == ref_total == g_total
    np.testing.assert_array_equal(packed, ref_packed)
    np.testing.assert_array_equal(packed, g_packed)
    mid = int(np.cumsum(cb.lengths[data].astype(np.int64))[999])
    for off, want in ((0, data), (mid, data[1000:])):
        out = nc.decode_bits(packed, total - off, want.size, cb, off)
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(out, ref_nc.decode_bits(
            packed, total - off, want.size, ref_cb, off))


def test_numpy_bit_codec_errors():
    data = np.array([0, 1, 2], np.uint8)
    lens = np.zeros(256, np.int32)
    lens[:2] = 1
    cb = Codebook.from_lengths(lens)
    with pytest.raises(ValueError, match="symbol 2 has no codeword"):
        nc.encode_bits(data, cb)
    with pytest.raises(ValueError, match="symbol 2 has no codeword"):
        ref_nc.encode_bits(data, RefCodebook.from_lengths(lens))
    packed, total = nc.encode_bits(data[:2], cb)
    with pytest.raises(ValueError, match="past end"):
        nc.decode_bits(packed, total, 5, cb)
    assert nc.encode_bits(b"", cb)[1] == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_rle_runs_and_entropy_fixture_equal_reference(seed):
    for kw in ({}, {"run_len": 7, "num_symbols": 200}):
        np.testing.assert_array_equal(
            testdata.rle_runs(5000 + seed, seed=seed, **kw),
            ref_testdata.rle_runs(5000 + seed, seed=seed, **kw))
    np.testing.assert_array_equal(
        testdata.entropy_fixture(n=1 << 15, seed=seed),
        ref_testdata.entropy_fixture(n=1 << 15, seed=seed))


def test_entropy_fixture_default_equals_reference():
    data = testdata.entropy_fixture()
    np.testing.assert_array_equal(data, ref_testdata.entropy_fixture())
    assert data.size == 1 << 20 and np.unique(data).size <= 32


@pytest.mark.parametrize("num_symbols", (4, 16, 100, 256))
def test_dummy_codebook_equals_reference(num_symbols):
    cb = testdata.dummy_codebook(num_symbols)
    ref = ref_testdata.dummy_codebook(num_symbols)
    np.testing.assert_array_equal(cb.lengths, ref.lengths)
    np.testing.assert_array_equal(cb.codes, ref.codes)
    assert cb.max_len == ref.max_len
    cb.validate()


@pytest.mark.parametrize("seed", SEEDS)
def test_scan_helpers_equal_reference(seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 9000, size=333).astype(np.int32)
    assert scan.total_bits_host(scan.exclusive_bit_offsets(
        torch.from_numpy(bits))) == ref_scan.total_bits_host(
        ref_scan.exclusive_bit_offsets(jnp.asarray(bits))) == int(
        bits.astype(np.int64).sum())
    lens = rng.integers(0, 25, size=(7, 1024)).astype(np.int32)
    ends = scan.block_bit_ends(torch.from_numpy(lens))
    assert ends.dtype == torch.int32
    np.testing.assert_array_equal(
        ends.numpy(), np.asarray(ref_scan.block_bit_ends(jnp.asarray(lens))))


@pytest.mark.parametrize("cap", (1, 40, 256))
def test_overflowed_equals_reference(cap):
    bits = np.array([0, 31, 32 * 40, 32 * 40 + 1, 4000], np.int32)
    for b in (bits, bits[:3], bits[:0]):
        got = encode_ops.overflowed(torch.from_numpy(b), cap)
        assert got.dtype == torch.bool and got.dim() == 0
        assert bool(got) == bool(ref_encode_ops.overflowed(jnp.asarray(b),
                                                           cap))


@pytest.mark.parametrize("seed", SEEDS)
def test_pack_reference_equals_reference_and_pack(seed):
    rng = np.random.default_rng(seed)
    cap = 6
    bits = rng.integers(0, cap * 32 + 1, size=50)
    bits[::7] = 0
    streams = testdata.random_block_streams(bits, cap, seed)
    out, total = pack_ops.pack_reference(streams.view(np.int32), bits)
    ref_out, ref_total = ref_pack_ops.pack_reference(streams, bits)
    assert total == ref_total == int(bits.sum())
    np.testing.assert_array_equal(out, ref_out)
    offs = scan.exclusive_bit_offsets(torch.from_numpy(bits))
    n_words = int(offs.total_words)
    packed = pack_ops.pack_blocks(torch.from_numpy(streams.view(np.int32)),
                                  torch.from_numpy(bits.astype(np.int32)),
                                  offs.word_base, offs.bit_shift, n_words)
    np.testing.assert_array_equal(packed.numpy().view(np.uint32),
                                  out[:n_words])


def _histograms():
    rng = np.random.default_rng(3)
    yield np.bincount(testdata.entropy_stream(1 << 16, seed=1), minlength=256)
    yield np.bincount(rng.integers(0, 256, 5000), minlength=256)
    yield np.bincount(testdata.skewed(20_000, num_symbols=200, decay=0.96,
                                      seed=4), minlength=256)
    h = np.zeros(256, np.int64)
    h[[3, 9]] = [1000, 1]
    yield h
    h = np.zeros(256, np.int64)
    h[7] = 5
    yield h


@pytest.mark.parametrize("k", range(5))
@pytest.mark.parametrize("cap", (8, 12, 16))
def test_estimates_equal_reference(k, cap):
    freqs = list(_histograms())[k]
    cb = Codebook.from_frequencies(freqs, cap)
    ref = RefCodebook.from_frequencies(freqs, cap)
    np.testing.assert_array_equal(cb.lengths, ref.lengths)
    for name in ("est_bpb", "est_w4_frac", "est_w8_frac", "est_w16_frac"):
        assert getattr(cb, name) is not None
        np.testing.assert_allclose(getattr(cb, name), getattr(ref, name),
                                   rtol=1e-12, atol=0)
    auto = Codebook.from_frequencies_auto(freqs, cap)
    ref_auto = RefCodebook.from_frequencies_auto(freqs, cap)
    np.testing.assert_array_equal(auto.lengths, ref_auto.lengths)
    np.testing.assert_allclose(auto.est_bpb, ref_auto.est_bpb, rtol=1e-12)
    again = Codebook.from_lengths(cb.lengths)
    assert (again.est_bpb, again.est_w4_frac, again.est_w8_frac,
            again.est_w16_frac) == (None, None, None, None)
