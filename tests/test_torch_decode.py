"""The plain PyTorch dense decoder (K4) against huffman_tpu.

The port's decode, on CPU tensors, against the Pallas kernel run by
decode_dense in interpret mode and the XLA decode_blocks, on streams the
JAX package encoded; tolerance zero (integer codec).  The CUDA kernel is
held against this plain version on the card by chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from huffman_tpu import api as ref_api
from huffman_tpu.config import CodecConfig as RefConfig
from huffman_tpu.ops import decode as ref_decode
from huffman_tpu.ops import scan as ref_scan
from huffman_tpu.ops.pallas.dense_decode import decode_dense

from huffman_tpu_torch import codebook as port_cb
from huffman_tpu_torch.ops import decode as p_decode
from huffman_tpu_torch.ops import scan
from huffman_tpu_torch.ops.cuda import dense_decode as k_decode
from huffman_tpu_torch.utils import testdata


def _encoded(n, nsym, bb, seed):
    data = testdata.skewed(n, num_symbols=nsym, seed=seed)
    return data, ref_api.encode(data, RefConfig(block_bytes=bb))


def _port_decode(enc, bb):
    bits = np.array(enc.block_bits, np.int32)        # writable copy
    offs = scan.exclusive_bit_offsets(torch.from_numpy(bits))
    cb = port_cb.Codebook.from_lengths(enc.codebook.lengths)
    tb = max(cb.max_len, 1)
    valid = ref_api.valid_per_block(enc.n_bytes, bits.size, bb)
    out = k_decode.decode_blocks(
        torch.from_numpy(enc.stream_words.view(np.int32)), offs.word_base,
        offs.bit_shift, torch.from_numpy(valid),
        torch.from_numpy(p_decode.table_entries(cb, tb)), tb, bb)
    return out.numpy().reshape(-1)[: enc.n_bytes]


def test_decode_vs_pallas_interpret():
    """Many 128-byte blocks over several subtiles, with a partial tail.
    (One case only: each interpret-mode call of the kernel costs ~20 s.)"""
    data, enc = _encoded(300 * 128 + 77, 32, 128, 3)
    got = _port_decode(enc, 128)
    ref = decode_dense(enc.stream_words, enc.block_bits, enc.n_bytes,
                       enc.codebook, block_bytes=128, interpret=True)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, data)


def _xla_decode(enc, bb):
    syms, lens = enc.codebook.decode_table()
    offs = ref_scan.exclusive_bit_offsets(jnp.asarray(enc.block_bits))
    valid = ref_api.valid_per_block(enc.n_bytes, len(enc.block_bits), bb)
    out = ref_decode.decode_blocks(
        jnp.asarray(np.concatenate([enc.stream_words, np.zeros(2, np.uint32)])),
        offs.word_base, offs.bit_shift, jnp.asarray(valid),
        jnp.asarray(syms), jnp.asarray(lens), bb, max(enc.codebook.max_len, 1))
    return np.asarray(out).reshape(-1)[: enc.n_bytes]


@pytest.mark.parametrize("n,bb,nsym,seed", [
    (3 * 1024 + 5, 1024, 256, 1),
    (2000, 128, 32, 2),
    (64, 64, 2, 6),                  # single block, 2-symbol book
])
def test_decode_vs_xla(n, bb, nsym, seed):
    data, enc = _encoded(n, nsym, bb, seed)
    got = _port_decode(enc, bb)
    np.testing.assert_array_equal(got, _xla_decode(enc, bb))
    np.testing.assert_array_equal(got, data)


@pytest.mark.parametrize("lens_head,mcl", [
    ([1, 2, 14, 14], 14),                          # tests/test_dense_decode.py:41
    (list(range(1, 21)) + [20], 20),               # a 2**20-entry table
])
def test_decode_long_codes_vs_xla(lens_head, mcl):
    """Codebooks past the Pallas kernel's 12-bit gate, which the port's
    decoder takes: the JAX package decodes them on its XLA reader."""
    from huffman_tpu.codebook import Codebook as RefCodebook
    lens = np.zeros(256, np.int32)
    lens[: len(lens_head)] = lens_head
    cb = RefCodebook.from_lengths(lens)
    rng = np.random.default_rng(mcl)
    p = 2.0 ** -np.asarray(lens_head, np.float64)
    data = rng.choice(len(lens_head), size=5000, p=p / p.sum()).astype(np.uint8)
    data[::97] = len(lens_head) - 1                 # longest codes present
    enc = ref_api.encode(data, RefConfig(block_bytes=128, max_code_len=mcl),
                         codebook=cb)
    got = _port_decode(enc, 128)
    np.testing.assert_array_equal(got, _xla_decode(enc, 128))
    np.testing.assert_array_equal(got, data)
