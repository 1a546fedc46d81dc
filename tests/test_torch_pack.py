"""The plain PyTorch dense pack (K2 + K3) against huffman_tpu.

The port's pack, on CPU tensors, against the Pallas pair run by
pack_dense_parallel in interpret mode, the XLA pack_blocks, the numpy twin
pack_reference and the golden encoder; tolerance zero (integer codec).
The CUDA kernel is held against this plain version on the card by
chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from huffman_tpu import api as ref_api
from huffman_tpu import golden as ref_golden
from huffman_tpu.codebook import Codebook as RefCodebook
from huffman_tpu.config import CodecConfig as RefConfig
from huffman_tpu.golden.numpy_codec import packed_bytes_to_words
from huffman_tpu.ops import pack as ref_pack
from huffman_tpu.ops.pallas.pack2 import pack_dense_parallel

from huffman_tpu_torch import codebook as port_cb
from huffman_tpu_torch.ops import pack as p_pack
from huffman_tpu_torch.ops import scan
from huffman_tpu_torch.ops.cuda import encode as k_encode
from huffman_tpu_torch.ops.cuda import pack2 as k_pack
from huffman_tpu_torch.utils import testdata


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _case(n, nsym, seed, cap_bpb):
    data = testdata.skewed(n, num_symbols=nsym, seed=seed)
    cfg = RefConfig(capacity_bits_per_byte=cap_bpb)
    blocks, n = ref_api._as_blocks(data, cfg)
    valid = ref_api.valid_per_block(n, blocks.shape[0], cfg.block_bytes)
    return data, blocks, valid, port_cb.Codebook.from_data(data, 12), cfg


def _port_encode(blocks, valid, cb, cap):
    return k_encode.encode_blocks(
        torch.from_numpy(blocks), torch.from_numpy(cb.codes.view(np.int32)),
        torch.from_numpy(cb.lengths.astype(np.int32)),
        torch.from_numpy(valid), cap)


def _offsets(bits_np):
    return scan.exclusive_bit_offsets(torch.from_numpy(bits_np))


@pytest.mark.parametrize("n,nsym,capb,seed", [
    (9 * 1024 + 999, 32, 8, 3),
    (3 * 1024, 256, 8, 5),
    (6 * 1024 + 11, 4, 4, 7),
])
def test_pack_vs_pallas_interpret_and_xla(n, nsym, capb, seed):
    data, blocks, valid, cb, cfg = _case(n, nsym, seed, capb)
    cap = -(-cfg.capacity_words // 128) * 128
    streams, bits = _port_encode(blocks, valid, cb, cap)
    offs = _offsets(bits.numpy())
    n_words = int(offs.total_words)
    got = _u32(k_pack.pack_blocks(streams, bits, offs.word_base,
                                  offs.bit_shift, n_words))
    ref_dense = np.asarray(pack_dense_parallel(
        jnp.asarray(_u32(streams)), bits.numpy(), interpret=True))
    np.testing.assert_array_equal(got, ref_dense[:n_words])
    ref_xla, _ = ref_pack.pack_blocks(jnp.asarray(_u32(streams)),
                                      jnp.asarray(bits.numpy()))
    np.testing.assert_array_equal(got, np.asarray(ref_xla)[:n_words])
    ref_bytes, ref_bits = ref_golden.encode(
        data, RefCodebook.from_lengths(cb.lengths))
    assert int(offs.total_bits) == ref_bits
    np.testing.assert_array_equal(got, packed_bytes_to_words(ref_bytes))


@pytest.mark.parametrize("cap,nb,kind,seed", [
    (128, 61, "mixed", 20),
    (256, 40, "mixed", 21),
    (384, 17, "mixed", 22),
    (128, 50, "full", 23),       # last source word live: the spill word
    (256, 33, "full", 24),
    (2, 700, "tiny", 25),        # runs of blocks share one output word
    (4, 513, "tiny", 26),
])
def test_pack_random_streams_vs_numpy_reference(cap, nb, kind, seed):
    """Random payload bits against the JAX package's numpy pack twin,
    ops.pack.pack_reference: any lengths with zero-bit rows ("mixed"),
    blocks within two words of capacity, whose shifted last word spills
    into the next block's first word ("full"), or 0..40 bits with a fifth
    of the rows empty, so that several blocks share one output word
    ("tiny")."""
    rng = np.random.default_rng(seed)
    if kind == "mixed":
        bits = rng.integers(0, cap * 32 + 1, size=nb)
        bits[rng.permutation(nb)[: nb // 5]] = 0
    elif kind == "tiny":
        bits = rng.integers(0, 41, size=nb)
        bits[rng.permutation(nb)[: nb // 5]] = 0
    else:
        bits = rng.integers(cap * 32 - 64, cap * 32 + 1, size=nb)
    words = testdata.random_block_streams(bits, cap, seed)
    bits = bits.astype(np.int32)
    offs = _offsets(bits)
    got = _u32(p_pack.pack_blocks(torch.from_numpy(words.view(np.int32)),
                                  torch.from_numpy(bits), offs.word_base,
                                  offs.bit_shift, int(offs.total_words)))
    ref_words, total = ref_pack.pack_reference(words, bits)
    assert total == int(offs.total_bits)
    np.testing.assert_array_equal(got, ref_words[: got.size])


@pytest.mark.parametrize("cap,kind,seed", [(2, "tiny", 27),
                                           (256, "mixed", 28)])
def test_pack_at_start_phase_vs_pack_at_offsets(cap, kind, seed):
    """A shard's blocks start at bit 13 of its first word
    (exclusive_bit_offsets(bits, 13), as parallel/pipeline.py packs them):
    the plain pack against the JAX package's pack_at_offsets on the same
    offsets."""
    rng = np.random.default_rng(seed)
    nb = 300 if kind == "tiny" else 40
    bits = rng.integers(0, 41 if kind == "tiny" else cap * 32 + 1, size=nb)
    bits[rng.permutation(nb)[: nb // 5]] = 0
    words = testdata.random_block_streams(bits, cap, seed)
    bits = bits.astype(np.int32)
    offs = scan.exclusive_bit_offsets(torch.from_numpy(bits), 13)
    n_words = int(offs.total_words)
    assert int(offs.bit_shift[0]) == 13
    got = _u32(p_pack.pack_blocks(torch.from_numpy(words.view(np.int32)),
                                  torch.from_numpy(bits), offs.word_base,
                                  offs.bit_shift, n_words))
    word_base = offs.word_base.numpy().astype(np.int32)
    ref = np.asarray(ref_pack.pack_at_offsets(
        jnp.asarray(words), jnp.asarray(word_base),
        jnp.asarray(offs.bit_shift.numpy()), n_words))
    np.testing.assert_array_equal(got, ref)
    assert got[0] >> 19 == 0                  # bits 0..12 of the stream empty
