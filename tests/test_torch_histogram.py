"""The port's byte histogram against the JAX package's.

Seeded numpy inputs go through huffman_tpu.ops.histogram.histogram_xla and
histogram_onehot on the CPU, as tests/test_ops.py runs them, and through
the port's histogram, histogram_xla and histogram_onehot (the plain
version, the CPU path of the kernel's wrapper).  Counts are integers:
tolerance zero.  The CUDA kernel (csrc/histogram.cu) is held to the plain
version on the card by chip_smoke.py.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from huffman_tpu.ops import histogram as ref_hist

from huffman_tpu_torch.ops import histogram as hist
from huffman_tpu_torch.ops.cuda import histogram as k_hist
from huffman_tpu_torch.utils import testdata

N = 5003                        # bytes, not a multiple of 4 or 16
KINDS = ("uniform", "main_profile", "one_byte")
# n_valid: absent, none, inside (not a multiple of 4), past the end
N_VALID = (None, 0, 2345, N + 100)
PORT_FNS = (hist.histogram, hist.histogram_xla, hist.histogram_onehot)


def _bytes(kind: str, n: int = N) -> np.ndarray:
    if kind == "uniform":
        return testdata.uniform_random(n, seed=11)
    if kind == "main_profile":
        return testdata.entropy_stream(n, seed=12)
    return np.full(n, 173, np.uint8)


def _as_words(data: np.ndarray) -> np.ndarray:
    """data zero-padded to whole little-endian 32-bit words."""
    pad = np.zeros(-data.size % 4, np.uint8)
    return np.concatenate([data, pad]).view("<u4")


def _want(data: np.ndarray, n_valid) -> np.ndarray:
    n = data.size if n_valid is None else min(n_valid, data.size)
    return np.bincount(data[:n], minlength=256)


def _ref_fns(n_bytes: int, n_valid) -> tuple:
    """The JAX functions that count exactly data[:n_valid]: with n_valid
    past the buffer, histogram_onehot also counts its tile's zero padding
    (the port clamps, as histogram_xla's dropped indices do)."""
    if n_valid is not None and n_valid > n_bytes:
        return (ref_hist.histogram_xla,)
    return ref_hist.histogram_xla, ref_hist.histogram_onehot


@pytest.mark.parametrize("n_valid", N_VALID)
@pytest.mark.parametrize("kind", KINDS)
def test_bytes_vs_jax(kind, n_valid):
    data = _bytes(kind)
    want = _want(data, n_valid)
    for ref_fn in _ref_fns(data.size, n_valid):
        np.testing.assert_array_equal(
            np.asarray(ref_fn(jnp.asarray(data), n_valid)), want)
    for fn in PORT_FNS:
        got = fn(torch.from_numpy(data), n_valid)
        assert got.dtype == torch.int64 and got.shape == (256,)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_valid", N_VALID)
@pytest.mark.parametrize("kind", KINDS)
def test_words_vs_jax(kind, n_valid):
    """u32 words read as their little-endian bytes, n_valid in bytes: the
    zero padding of the last word is counted only when n_valid says so."""
    data = _bytes(kind)
    words = _as_words(data)
    n_bytes = None if n_valid is None else n_valid
    want = _want(words.view(np.uint8), n_bytes)
    for ref_fn in _ref_fns(4 * words.size, n_valid):
        # histogram_xla takes bytes; histogram_onehot the words themselves
        ref_in = (words if ref_fn is ref_hist.histogram_onehot
                  else words.view(np.uint8))
        np.testing.assert_array_equal(
            np.asarray(ref_fn(jnp.asarray(ref_in), n_bytes)), want)
    for dtype in (torch.int32, torch.uint32):
        t = torch.from_numpy(words.view(np.int32)).view(dtype)
        for fn in PORT_FNS:
            np.testing.assert_array_equal(fn(t, n_bytes).numpy(), want)
    # the same words as a 2-D block of rows
    rows = torch.from_numpy(words[: words.size // 41 * 41]
                            .view(np.int32).reshape(41, -1))
    np.testing.assert_array_equal(
        hist.histogram(rows, n_bytes).numpy(),
        _want(words[: rows.numel()].view(np.uint8), n_bytes))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.uint32])
@pytest.mark.parametrize("n_valid", [None, 0, 7])
def test_empty_input(dtype, n_valid):
    ref = np.asarray(ref_hist.histogram_onehot(jnp.zeros(0, jnp.uint8),
                                               n_valid))
    for fn in PORT_FNS:
        got = fn(torch.zeros(0, dtype=dtype), n_valid)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert int(got.sum()) == 0


def test_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor goes to the plain version and launches nothing; the
    plain version counts no CUDA call."""
    data = torch.from_numpy(_bytes("main_profile"))
    launches, plain_calls = k_hist.launches.n, hist.cuda_calls.n
    got = k_hist.histogram(data[3:], 1000)
    np.testing.assert_array_equal(got.numpy(),
                                  hist.histogram_plain(data[3:], 1000).numpy())
    np.testing.assert_array_equal(got.numpy(),
                                  _want(data[3:].numpy(), 1000))
    assert (k_hist.launches.n, hist.cuda_calls.n) == (launches, plain_calls)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int64, torch.int16,
                                   torch.bool])
def test_unsupported_dtype_raises(dtype):
    with pytest.raises(ValueError, match="want uint8 bytes or 32-bit words"):
        hist.histogram(torch.zeros(8, dtype=dtype))


def test_wrapper_raises_off_cpu_and_cuda():
    meta = torch.empty(64, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k_hist.histogram(meta, 10)
    with pytest.raises(ValueError, match="unsupported device"):
        hist.histogram(meta)


def test_wrapper_names_its_source_and_tpu_function():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.exists(os.path.join(root, k_hist.SOURCE))
    path, line = k_hist.REPLACES.split(":")
    assert path == "huffman_tpu/ops/histogram.py"
    src = open(os.path.join(root, path)).read().splitlines()
    assert src[int(line) - 1].startswith("def histogram_onehot(")
    # the entry point is registered with the kernels' library
    from huffman_tpu_torch.ops.cuda import _build
    assert "huff_histogram" in _build._SIGNATURES
    assert "huff_histogram" in open(os.path.join(root, k_hist.SOURCE)).read()
