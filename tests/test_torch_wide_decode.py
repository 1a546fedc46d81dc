"""The plain PyTorch wide decoder (K8's CPU path) against huffman_tpu.

decode_tiles is held bit for bit against the JAX package's reader kernel
in interpret mode on one container written by the format's specification
(golden/wide_codec.py), and against the specification's own reader on
more cases: partial tiles, narrow and 12-bit codebooks, and a subset of
tiles decoded on its own.  The CUDA kernel is held against this plain
version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from huffman_tpu import wide as ref_wide
from huffman_tpu.codebook import Codebook as RefCodebook
from huffman_tpu.config import CodecConfig as RefConfig

from huffman_tpu_torch import wide
from huffman_tpu_torch.codebook import Codebook
from huffman_tpu_torch.golden import wide_codec as W
from huffman_tpu_torch.ops.cuda import wide_decode as k_decode
from huffman_tpu_torch.ops.decode import table_entries
from huffman_tpu_torch.utils import testdata

TILE = W.TILE_BYTES


def golden_encoded(data, cb) -> wide.WideEncoded:
    """A port WideEncoded holding the spec encoder's payload."""
    tiles, n = W.encode(data, cb.codes, cb.lengths)
    payload = np.concatenate([np.concatenate([p0, p1]) for p0, p1, _ in tiles])
    return wide.WideEncoded(
        payload, np.array([p0.size for p0, _, _ in tiles], np.int32),
        np.stack([b for _, _, b in tiles]).astype(np.int32), cb, n,
        wide.CodecConfig(max_code_len=12))


def plain_decode(enc, t0=0, t1=None):
    """decode_tiles on CPU tensors over tiles [t0, t1)."""
    t1 = len(enc.tile_words) if t1 is None else t1
    tw = enc.tile_words.astype(np.int64)
    start = np.concatenate([[0], np.cumsum(2 * tw)])
    mcl = wide.reader_mcl(enc.codebook)
    span = enc.payload_words[start[t0]: start[t1]]
    out = k_decode.decode_tiles(
        torch.from_numpy(span.view(np.int32)),
        torch.from_numpy(start[t0:t1] - start[t0]),
        torch.from_numpy(tw[t0:t1].astype(np.int32)),
        torch.from_numpy(enc.bases[t0:t1]),
        torch.from_numpy(wide.tile_bytes(enc.n_bytes, t0, t1)),
        torch.from_numpy(table_entries(enc.codebook, mcl)), mcl)
    assert out.dtype == torch.uint8 and out.shape == (t1 - t0, TILE)
    return out.numpy()


def test_decode_tiles_equals_reference_kernel():
    data = testdata.skewed(2 * TILE - 4321, num_symbols=48, decay=0.85,
                           seed=21)
    cb = Codebook.from_data(data, 12)
    enc = golden_encoded(data, cb)
    ref_enc = ref_wide.WideEncoded(
        enc.payload_words, enc.tile_words, enc.bases,
        RefCodebook.from_lengths(cb.lengths), enc.n_bytes, RefConfig())
    ref_out = ref_wide.decode_wide(ref_enc, interpret=True)
    out = plain_decode(enc)
    np.testing.assert_array_equal(out.reshape(-1)[: data.size], ref_out)
    np.testing.assert_array_equal(ref_out, data)
    assert not out.reshape(-1)[data.size:].any()     # zero past the input


DECODE_CASES = [
    # n, nsym, max_code_len, seed
    (5000, 256, 12, 1),
    (TILE, 1, 12, 2),                 # a one-symbol book: 1-bit codes
    (2 * TILE - 1, 32, 12, 3),
    (3 * TILE - 5000, 20, 8, 4),
    (100000, 11, 4, 5),
]


@pytest.mark.parametrize("n,nsym,mcap,seed", DECODE_CASES)
def test_decode_tiles_equals_spec_reader(n, nsym, mcap, seed):
    data = testdata.skewed(n, num_symbols=nsym, seed=seed)
    cb = Codebook.from_data(data, mcap)
    enc = golden_encoded(data, cb)
    mcl = wide.reader_mcl(cb)
    tiles = [(enc.payload_words[s: s + w], enc.payload_words[s + w: s + 2 * w],
              b) for s, w, b in zip(np.concatenate(
                  [[0], np.cumsum(2 * enc.tile_words[:-1].astype(np.int64))]),
                  enc.tile_words, enc.bases)]
    syms, lens = cb.decode_table(mcl)
    spec = W.decode(tiles, n, syms, lens, mcl, mcl)
    np.testing.assert_array_equal(spec, data)
    np.testing.assert_array_equal(plain_decode(enc).reshape(-1)[:n], spec)


def test_decode_tiles_subset_and_reads_past_the_payload():
    """Tiles decode on their own from their own payload span; a tile whose
    reads run past the span (a truncated payload) sees zeros."""
    data = testdata.skewed(3 * TILE + 999, num_symbols=30, seed=8)
    cb = Codebook.from_data(data, 12)
    enc = golden_encoded(data, cb)
    out = plain_decode(enc, 1, 3)
    np.testing.assert_array_equal(out.reshape(-1), data[TILE: 3 * TILE])
    last = plain_decode(enc, 3, 4)
    np.testing.assert_array_equal(last[0, :999], data[3 * TILE:])
    rest = (enc.tile_words, enc.bases, enc.codebook, enc.n_bytes, enc.config)
    cut = plain_decode(wide.WideEncoded(enc.payload_words[:-5], *rest), 3, 4)
    zeroed = enc.payload_words.copy()
    zeroed[-5:] = 0
    np.testing.assert_array_equal(
        cut, plain_decode(wide.WideEncoded(zeroed, *rest), 3, 4))
