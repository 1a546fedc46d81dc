"""The port's offset scan against the JAX package's.

Seeded numpy counts go through huffman_tpu.ops.scan.exclusive_bit_offsets
and total_bits_host on the CPU, as tests/test_ops.py runs them, and
through the port's exclusive_bit_offsets (the CPU path of the kernel's
wrapper), its plain version and the wrapper itself; a start bit is given
to the JAX scan as a leading block of that many bits.  The wide payload
offsets go against the host cumsum of 2 * tile_words that
huffman_tpu/wide.py uses.  Offsets are integers: tolerance zero.  The CUDA
kernel (csrc/scan.cu) is held to the plain version on the card by
chip_smoke.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffman_tpu.ops import scan as ref_scan

from huffman_tpu_torch import wide
from huffman_tpu_torch.config import CodecConfig
from huffman_tpu_torch.ops import scan
from huffman_tpu_torch.ops.cuda import scan as k_scan

TILE = k_scan.TILE
SIZES = (0, 1, 31, TILE - 1, TILE, TILE + 1, 3 * TILE + 7)
STARTS = (0, 1, 17, 31)
CAP_BITS = CodecConfig().capacity_words * 32      # a 1 KiB block's capacity
BITS24 = 1024 * 24                                # 1 KiB of 24-bit codes
BIG24 = 262144 * 24                               # 256 KiB of 24-bit codes
PROFILES = ("zeros", "capacity", "bits24", "random")
PORT_FNS = (scan.exclusive_bit_offsets, scan.exclusive_bit_offsets_plain,
            k_scan.bit_offsets)


def _bits(profile: str, n: int) -> np.ndarray:
    if profile == "zeros":
        return np.zeros(n, np.int32)
    if profile == "capacity":
        return np.full(n, CAP_BITS, np.int32)
    if profile == "bits24":
        return np.full(n, BITS24, np.int32)
    return np.random.default_rng(n).integers(0, BITS24 + 1, n).astype(np.int32)


def _want(bits: np.ndarray, start: int):
    """numpy int64: each block's first bit from `start`, and the end bit."""
    ends = np.cumsum(bits.astype(np.int64)) + start
    return ends - bits, int(ends[-1]) if bits.size else start


def _jax_offsets(bits: np.ndarray, start: int):
    """The JAX scan of the blocks after a leading block of `start` bits."""
    ref = ref_scan.exclusive_bit_offsets(
        jnp.asarray(np.concatenate([[start], bits]).astype(np.int32)))
    return (np.asarray(ref.word_base)[1:], np.asarray(ref.bit_shift)[1:],
            int(ref.total_words), ref_scan.total_bits_host(ref))


def _assert_port(bits: np.ndarray, start: int, word_base, bit_shift,
                 total_words: int, total_bits: int) -> None:
    for fn in PORT_FNS:
        got = fn(torch.from_numpy(bits), start)
        assert got.word_base.dtype == torch.int64
        assert got.bit_shift.dtype == torch.int32
        assert got.total_bits.dim() == got.total_words.dim() == 0
        np.testing.assert_array_equal(got.word_base.numpy(), word_base)
        np.testing.assert_array_equal(got.bit_shift.numpy(), bit_shift)
        assert int(got.total_words) == total_words
        assert scan.total_bits_host(got) == total_bits


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("n", SIZES)
def test_offsets_vs_jax(n, start, profile):
    bits = _bits(profile, n)
    word_base, bit_shift, total_words, total_bits = _jax_offsets(bits, start)
    starts, end = _want(bits, start)
    np.testing.assert_array_equal(word_base, starts >> 5)
    np.testing.assert_array_equal(bit_shift, starts & 31)
    assert total_bits == end and total_words == (end + 31) >> 5
    _assert_port(bits, start, word_base, bit_shift, total_words, total_bits)


@pytest.mark.parametrize("start", STARTS)
def test_total_past_2_32_vs_jax(start):
    """700 blocks of 256 KiB at 24 bits a byte: 4.4e9 bits, past 2^32 (the
    JAX split form's words stay below 2^31)."""
    bits = np.full(700, BIG24, np.int32)
    bits[::3] = BIG24 - 7 * start - 1
    word_base, bit_shift, total_words, total_bits = _jax_offsets(bits, start)
    assert total_bits > 1 << 32
    assert total_bits == _want(bits, start)[1]
    _assert_port(bits, start, word_base, bit_shift, total_words, total_bits)


@pytest.mark.parametrize("start", STARTS)
def test_word_base_past_2_31(start):
    """3 tiles and 7 such blocks: 7.7e10 bits, a word_base past 2^31, where
    the JAX package's int32 words would wrap; against numpy in int64."""
    bits = np.full(3 * TILE + 7, BIG24, np.int32)
    bits[1::50] = 0
    starts, end = _want(bits, start)
    assert starts[-1] >> 5 > 1 << 31
    _assert_port(bits, start, starts >> 5, starts & 31, (end + 31) >> 5, end)


@pytest.mark.parametrize("dtype", [torch.int64, torch.uint8, torch.int16])
def test_other_integer_dtypes_on_cpu(dtype):
    """The plain version takes any integer counts on the CPU (the kernel
    takes int32)."""
    bits = np.random.default_rng(9).integers(0, 120, 333)
    want = scan.exclusive_bit_offsets(torch.from_numpy(bits.astype(np.int32)),
                                      5)
    got = scan.exclusive_bit_offsets(torch.from_numpy(bits).to(dtype), 5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _tile_words(kind: str, nt: int) -> np.ndarray:
    if kind == "max":
        return np.full(nt, (1 << 31) - 1, np.int32)
    return np.random.default_rng(nt).integers(0, 200_000, nt).astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "max"])
@pytest.mark.parametrize("nt", [0, 1, 3, TILE - 1, TILE + 1])
def test_payload_offsets_vs_host(nt, kind):
    """Against huffman_tpu/wide.py's host offsets, np.cumsum(2 * tw); at
    int32's largest tile words the payload passes 2^32 words."""
    tw = _tile_words(kind, nt)
    tile_start = np.concatenate([[0], np.cumsum(2 * tw.astype(np.int64))])
    t = torch.from_numpy(tw)
    offsets, n_words = wide.payload_offsets(t)
    assert offsets.dtype == torch.int64 and isinstance(n_words, int)
    np.testing.assert_array_equal(offsets.numpy(), tile_start[:-1])
    assert n_words == int(tile_start[-1])
    for fn in (k_scan.payload_offsets, scan.payload_offsets_plain):
        got, total = fn(t)
        np.testing.assert_array_equal(got.numpy(), tile_start[:-1])
        assert total.dim() == 0 and int(total) == n_words


def test_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor goes to the plain version and launches nothing; the
    plain version counts no CUDA call."""
    bits = torch.from_numpy(_bits("random", TILE + 1))
    counts = k_scan.launches.n, scan.cuda_calls.n
    got = k_scan.bit_offsets(bits, 3)
    want = scan.exclusive_bit_offsets_plain(bits, 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    k_scan.payload_offsets(bits)
    assert (k_scan.launches.n, scan.cuda_calls.n) == counts


@pytest.mark.parametrize("fn", [
    lambda x: scan.exclusive_bit_offsets(x), lambda x: k_scan.bit_offsets(x),
    lambda x: k_scan.payload_offsets(x), lambda x: wide.payload_offsets(x)])
def test_wrapper_raises_off_cpu_and_cuda(fn):
    with pytest.raises(ValueError, match="unsupported device"):
        fn(torch.zeros(64, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bool,
                                   torch.complex64])
def test_unsupported_dtype_raises(dtype):
    x = torch.zeros(8, dtype=dtype)
    with pytest.raises(ValueError, match="want integer counts"):
        scan.exclusive_bit_offsets(x)
    with pytest.raises(ValueError, match="want integer counts"):
        wide.payload_offsets(x)


@pytest.mark.parametrize("start", [-1, 32, 100])
def test_start_bit_out_of_range_raises(start):
    with pytest.raises(ValueError, match="outside 0..31"):
        scan.exclusive_bit_offsets(torch.zeros(8, dtype=torch.int32), start)


def test_not_1d_raises():
    with pytest.raises(ValueError, match="want a 1-D tensor"):
        scan.exclusive_bit_offsets(torch.zeros(2, 4, dtype=torch.int32))


def test_wrapper_names_its_source_and_tpu_function():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.exists(os.path.join(root, k_scan.SOURCE))
    path, line = k_scan.REPLACES.split(":")
    assert path == "huffman_tpu/ops/scan.py"
    src = open(os.path.join(root, path)).read().splitlines()
    assert src[int(line) - 1].startswith("def exclusive_bit_offsets(")
    # the entry point is registered with the kernels' library, and the
    # kernel's tile is the wrapper's
    from huffman_tpu_torch.ops.cuda import _build
    assert "huff_bit_offsets" in _build._SIGNATURES
    text = open(os.path.join(root, k_scan.SOURCE)).read()
    assert "HUFF_API int huff_bit_offsets(" in text
    assert f"SCAN_TILE = SCAN_WARPS * WARP_ITEMS;    // {TILE}" in text
