"""The plain PyTorch versions of the wide-format kernels against huffman_tpu.

sub_encode (K5), schedule_counts and emit_planes (K6 + K7) are held bit
for bit (tolerance zero: integer codec) against the JAX package's Pallas
kernels in interpret mode and its XLA schedule scan, on one 2-tile input,
and the whole plain encode pipeline against the format's specification
(golden/wide_codec.py) on inputs of 1, 2 and 3 tiles.  The CUDA kernels
are held against these plain versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from huffman_tpu import wide as ref_wide

from huffman_tpu_torch import wide
from huffman_tpu_torch.codebook import Codebook
from huffman_tpu_torch.golden import wide_codec as W
from huffman_tpu_torch.ops import wide as p_wide
from huffman_tpu_torch.ops.cuda import wide_emit as k_emit
from huffman_tpu_torch.ops.cuda import wide_encode as k_sub
from huffman_tpu_torch.utils import testdata

TILE = W.TILE_BYTES


def golden_fields(data, cb):
    """The spec's (payload words, tile_words, bases) of a stream."""
    tiles, _ = W.encode(data, cb.codes, cb.lengths)
    payload = np.concatenate([np.concatenate([p0, p1]) for p0, p1, _ in tiles])
    return (payload, np.array([p0.size for p0, _, _ in tiles], np.int32),
            np.stack([b for _, _, b in tiles]).astype(np.int32))


def _tensors(cb):
    return (torch.from_numpy(cb.codes.astype(np.uint32).view(np.int32)),
            torch.from_numpy(cb.lengths.astype(np.int32)))


def plain_encode(data, cb, slot=None):
    """The port's encode pipeline on CPU tensors, stage by stage:
    (streams, bits, l2, tile_bytes, bases, tile_words, offsets, payload)."""
    rows, valid = wide.device_substreams(data, torch.device("cpu"))
    mcl = wide.reader_mcl(cb)
    codes, lengths = _tensors(cb)
    streams, bits, l2 = k_sub.sub_encode(rows, codes, lengths, valid,
                                         slot or wide.slot_words(mcl))
    nt = rows.shape[0] // W.N_SUB
    tb = torch.from_numpy(wide.tile_bytes(data.size, 0, nt))
    bases, tw, masks = k_emit.schedule_counts(l2, tb, mcl)
    offsets, n_words = wide.payload_offsets(tw)
    payload = k_emit.emit_planes(streams, masks, bases, tw, offsets, n_words)
    return streams, bits, l2, tb, bases, tw, offsets, payload


@pytest.fixture(scope="module")
def two_tiles():
    """One 2-tile input (partial second tile, 12-bit codes) through the
    JAX package's safe substream tree and emit, in interpret mode."""
    data = testdata.skewed(2 * TILE - 3000, num_symbols=40, decay=0.8,
                           seed=11)
    cb = Codebook.from_data(data, 12)
    assert cb.max_len == 12
    nb = 2 * TILE // 1024
    blocks = np.zeros(nb * 1024, np.uint8)
    blocks[: data.size] = data
    valid = np.clip(data.size - 1024 * np.arange(nb), 0, 1024).astype(np.int32)
    streams, l2 = ref_wide._sub_encode_device(
        jnp.asarray(blocks.reshape(nb, 1024)), jnp.asarray(cb.codes),
        jnp.asarray(cb.lengths), jnp.asarray(valid), interpret=True,
        spec_chunks=0)
    return data, cb, valid, np.asarray(streams), np.asarray(l2)


def test_sub_encode_equals_reference(two_tiles):
    data, cb, _, ref_streams, ref_l2 = two_tiles
    streams, bits, l2, *_ = plain_encode(data, cb, slot=128)
    # JAX block b's substream s (slot 128 at words [128s, 128s + 128)) is
    # row 4b + s of the port's (NS, slot) streams
    np.testing.assert_array_equal(streams.numpy().view(np.uint32),
                                  ref_streams.reshape(-1, 128))
    np.testing.assert_array_equal(l2.numpy(), ref_l2.reshape(-1, 64))
    np.testing.assert_array_equal(bits.numpy(),
                                  ref_l2.reshape(-1, 64).sum(axis=1))
    # the wide path's slot, 8 * mcl + 2 words, keeps the same words
    narrow = plain_encode(data, cb)[0].numpy().view(np.uint32)
    assert narrow.shape[1] == wide.slot_words(12) == 98
    np.testing.assert_array_equal(narrow, ref_streams.reshape(-1, 128)[:, :98])
    assert not ref_streams.reshape(-1, 128)[:, 98:].any()


def test_schedule_counts_equals_reference(two_tiles):
    data, cb, valid, _, ref_l2 = two_tiles
    nt = 2
    mcl = wide.reader_mcl(cb)
    ref_bases, ref_cnts = ref_wide._schedule_counts(
        ref_wide._l2p_device(jnp.asarray(ref_l2), nt),
        ref_wide._nk_device(jnp.asarray(valid), nt).reshape(nt, W.N_SUB), mcl)
    ref_bases, ref_cnts = np.asarray(ref_bases), np.asarray(ref_cnts)
    l2 = torch.from_numpy(ref_l2.reshape(-1, 64).astype(np.uint8))
    tb = torch.from_numpy(wide.tile_bytes(data.size, 0, nt))
    bases, tw, masks = p_wide.schedule_counts(l2, tb, mcl)
    np.testing.assert_array_equal(bases.numpy(), ref_bases)
    np.testing.assert_array_equal(tw.numpy(),
                                  ref_bases[:, -1] + ref_cnts[:, -1])
    # the masks hold the same schedule: round j's pulls, tile by tile
    bits = (masks.view(nt, W.N_SUB, 1) >> torch.arange(64)) & 1
    np.testing.assert_array_equal(bits.sum(1).numpy(), ref_cnts)


def test_emit_planes_equals_reference(two_tiles):
    data, cb, valid, ref_streams, ref_l2 = two_tiles
    mcl = wide.reader_mcl(cb)
    p0, p1, ref_bases, ref_cnts = ref_wide._emit_device(
        jnp.asarray(ref_streams), jnp.asarray(ref_l2), jnp.asarray(valid),
        jnp.int32(mcl), interpret=True, max_words=8 * 12)
    ref_bases, ref_cnts = np.asarray(ref_bases), np.asarray(ref_cnts)
    ref_tw = ref_bases[:, -1] + ref_cnts[:, -1]
    p0 = np.asarray(p0).reshape(2, -1)
    p1 = np.asarray(p1).reshape(2, -1)
    ref_payload = np.concatenate(
        [np.concatenate([p0[t, :w], p1[t, :w]]) for t, w in enumerate(ref_tw)])
    *_, bases, tw, _, payload = plain_encode(data, cb)
    np.testing.assert_array_equal(tw.numpy(), ref_tw)
    np.testing.assert_array_equal(bases.numpy(), ref_bases)
    np.testing.assert_array_equal(payload.numpy().view(np.uint32), ref_payload)
    # and the JAX kernels equal the spec here too
    g_payload, g_tw, g_bases = golden_fields(data, cb)
    np.testing.assert_array_equal(ref_payload, g_payload)


GOLDEN_CASES = [
    # n, nsym, max_code_len, seed
    (5000, 256, 12, 1),               # one partial tile, full alphabet
    (TILE, 2, 12, 2),                 # exactly one tile, 1-bit codes
    (2 * TILE - 777, 32, 12, 3),      # 2 tiles, partial second
    (3 * TILE - 5000, 24, 8, 4),      # 3 tiles (no power of two), mcl <= 8
    (TILE + 1234, 9, 4, 5),           # mcl <= 4
]


@pytest.mark.parametrize("n,nsym,mcap,seed", GOLDEN_CASES)
def test_plain_pipeline_equals_spec(n, nsym, mcap, seed):
    data = testdata.skewed(n, num_symbols=nsym, seed=seed)
    cb = Codebook.from_data(data, mcap)
    assert cb.max_len <= mcap
    streams, bits, l2, tb, bases, tw, offsets, payload = plain_encode(data, cb)
    g_payload, g_tw, g_bases = golden_fields(data, cb)
    np.testing.assert_array_equal(tw.numpy(), g_tw)
    np.testing.assert_array_equal(bases.numpy(), g_bases)
    np.testing.assert_array_equal(payload.numpy().view(np.uint32), g_payload)
    # each substream's bits fit its slot, and l2 sums to them
    assert int(bits.max()) <= 32 * (streams.shape[1] - 2)
    np.testing.assert_array_equal(l2.to(torch.int64).sum(1).numpy(),
                                  bits.numpy())


def test_uniform_256_symbols_equals_spec():
    """Every code 8 bits: each full substream is 64 words, and every
    substream pulls in the same rounds."""
    data = testdata.uniform_random(TILE + 4096, seed=6)
    cb = Codebook.from_lengths(np.full(256, 8))
    *_, bases, tw, _, payload = plain_encode(data, cb)
    g_payload, g_tw, g_bases = golden_fields(data, cb)
    np.testing.assert_array_equal(tw.numpy(), g_tw)
    np.testing.assert_array_equal(bases.numpy(), g_bases)
    np.testing.assert_array_equal(payload.numpy().view(np.uint32), g_payload)
    assert int(tw[0]) == W.N_SUB * 64 // 2


def test_longest_codes_fill_the_buffer():
    """Substreams of 12-bit codes only: 96 words each, and the reader's
    buffer reaches its bound of 111 bits."""
    lens = np.zeros(256, np.int32)
    lens[:13] = list(range(1, 13)) + [12]          # Kraft sum exactly 1
    cb = Codebook.from_lengths(lens)
    rng = np.random.default_rng(7)
    data = rng.integers(0, 13, size=TILE // 2).astype(np.uint8)
    data[: TILE // 4] = rng.integers(11, 13, size=TILE // 4)
    streams, bits, l2, tb, bases, tw, offsets, payload = plain_encode(data, cb)
    assert int(bits.max()) == 256 * 12 == 32 * (streams.shape[1] - 2)
    g_payload, g_tw, g_bases = golden_fields(data, cb)
    np.testing.assert_array_equal(payload.numpy().view(np.uint32), g_payload)
    np.testing.assert_array_equal(bases.numpy(), g_bases)
    # replay the schedule: avail peaks at the bound of the 128-bit buffer
    n_k = p_wide.substream_valid(tb)
    lens_j = l2.to(torch.int64).view(1, W.N_SUB, 64)
    avail = torch.zeros_like(n_k)
    peak = 0
    for j in range(W.ROUNDS):
        pull = p_wide.pull_mask(avail, n_k, j, 12)
        peak = max(peak, int((avail + 64 * pull).max()))
        avail = avail + 64 * pull - lens_j[:, :, j]
    assert peak == 111
