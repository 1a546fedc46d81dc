"""The port's sharded codec on CPU, against huffman_tpu's ShardedCodec.

ShardedCodec over make_mesh(devices=["cpu"] * k) (k shards of the one CPU
device; the kernel wrappers run their plain versions) against the JAX
package's ShardedCodec on the 8 virtual CPU devices of conftest.py, the
golden encoder and the port's single-device api.encode and
wide.encode_wide: the same stream words and totals, byte-identical
containers, and every sharded decode equal to the input.  Tolerance zero
throughout.
"""

import numpy as np
import pytest
import torch

from huffman_tpu import golden as ref_golden
from huffman_tpu.codebook import Codebook as RefCodebook
from huffman_tpu.golden.numpy_codec import packed_bytes_to_words
from huffman_tpu.parallel.mesh import make_mesh as ref_make_mesh
from huffman_tpu.parallel.pipeline import ShardedCodec as RefShardedCodec

from huffman_tpu_torch import api, container, wide
from huffman_tpu_torch.codebook import Codebook
from huffman_tpu_torch.config import CodecConfig
from huffman_tpu_torch.golden.wide_codec import TILE_BYTES
from huffman_tpu_torch.ops import wide as plain_wide
from huffman_tpu_torch.parallel.mesh import make_mesh, pad_blocks_for_mesh
from huffman_tpu_torch.parallel.pipeline import (ShardedCodec, assemble_dense,
                                                 histogram_sharded)
from huffman_tpu_torch.utils import testdata
from huffman_tpu_torch.utils.device import DeviceError


def cpu_codec(k: int, cfg: CodecConfig = CodecConfig()) -> ShardedCodec:
    return ShardedCodec(make_mesh(devices=["cpu"] * k), cfg)


def golden_words(data, cb):
    g_bytes, g_bits = ref_golden.encode(data, RefCodebook.from_lengths(
        cb.lengths))
    return packed_bytes_to_words(g_bytes), g_bits


def test_mesh_shape_and_errors(monkeypatch):
    mesh = make_mesh(3, devices=["cpu"] * 8)
    assert mesh.size == 3 and mesh.local_shards == [0, 1, 2]
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert pad_blocks_for_mesh(13, mesh) == 15
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        make_mesh(9, devices=["cpu"] * 8)
    # the default mesh is every CUDA device, and never the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError, match="no cuda devices"):
        make_mesh()


@pytest.mark.parametrize("k", [1, 3, 8])
def test_histogram_sharded(k):
    codec = cpu_codec(k)
    data = testdata.uniform_random(100_000, seed=1)
    arr, nb = codec.prepare(data)
    assert nb == pad_blocks_for_mesh(98, codec.mesh)
    d_blocks, d_valid = codec.shard_inputs(arr, nb)
    np.testing.assert_array_equal(
        histogram_sharded(codec.mesh)(d_blocks, d_valid),
        np.bincount(data, minlength=256))


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("n", [1024, 100_000, 131072])
def test_encode_equals_reference_golden_and_single_device(k, n):
    data = testdata.skewed(n, num_symbols=32, seed=n + k)
    enc = cpu_codec(k).encode(data)
    ref = RefShardedCodec(ref_make_mesh(k)).encode(data, use_pallas=False)
    np.testing.assert_array_equal(enc.codebook.lengths, ref.codebook.lengths)
    assert enc.total_bits == ref.total_bits
    np.testing.assert_array_equal(enc.stream_words, ref.stream_words)
    # the JAX package keeps the blocks that pad to the mesh; the port trims
    np.testing.assert_array_equal(enc.block_bits,
                                  ref.block_bits[: len(enc.block_bits)])
    assert not ref.block_bits[len(enc.block_bits):].any()
    words, bits = golden_words(data, enc.codebook)
    assert enc.total_bits == bits
    np.testing.assert_array_equal(enc.stream_words, words)
    single = api.encode(data, device="cpu")
    assert container.dumps(enc) == container.dumps(single)


UNEVEN = [
    # n, shards, block_bytes, codebook lengths (None: exact), seed
    (12_345, 8, 1024, None, 4),          # tail over neither blocks nor mesh
    (100, 8, 1024, None, 5),             # fewer blocks than shards
    (10_000, 8, 256, None, 9),           # small blocks
    (7 * 1024 + 3, 3, 1024, 8, 10),      # 8-bit codes: seams on word edges
]


@pytest.mark.parametrize("n,k,bb,flat,seed", UNEVEN)
def test_encode_uneven_and_decode(n, k, bb, flat, seed):
    cfg = CodecConfig(block_bytes=bb)
    data = testdata.skewed(n, num_symbols=16, seed=seed)
    cb = None if flat is None else Codebook.from_lengths(np.full(256, flat))
    codec = cpu_codec(k, cfg)
    enc = codec.encode(data, codebook=cb)
    single = api.encode(data, cfg, codebook=cb, device="cpu")
    assert container.dumps(enc) == container.dumps(single)
    words, bits = golden_words(data, enc.codebook)
    assert enc.total_bits == bits
    np.testing.assert_array_equal(enc.stream_words, words)
    np.testing.assert_array_equal(codec.decode(enc), data)


def test_assemble_dense_seams():
    # shard 0: 40 bits; shard 1: empty, a shift-only seam; shard 2: 24 bits
    # from bit 40; shard 3: empty at a word edge
    s0 = np.array([0xFFFFFFFF, 0xFF000000], np.uint32)
    s2 = np.array([0x00ABCDEF], np.uint32)
    out = assemble_dense([s0, np.zeros(1, np.uint32), s2,
                          np.zeros(0, np.uint32)],
                         np.array([0, 1, 1, 2]), np.array([2, 1, 1, 0]), 2)
    np.testing.assert_array_equal(out, [0xFFFFFFFF, 0xFFABCDEF])


def test_missing_symbol_raises():
    data = testdata.skewed(40_000, num_symbols=4, seed=12)
    data[17_000] = 200
    cb = Codebook.from_data(data[:17_000])
    with pytest.raises(ValueError, match="absent from the codebook"):
        cpu_codec(8).encode(data, codebook=cb)


@pytest.mark.parametrize("k,encoder", [(2, "sharded"), (8, "sharded"),
                                       (8, "single")])
def test_decode_roundtrip(k, encoder):
    data = testdata.skewed(77_777, num_symbols=64, seed=6 + k)
    codec = cpu_codec(k)
    enc = (codec.encode(data) if encoder == "sharded"
           else api.encode(data, device="cpu"))
    np.testing.assert_array_equal(codec.decode(enc), data)


def test_padding_tile_schedules_nothing():
    l2 = torch.zeros((plain_wide.N_SUB, plain_wide.ITEMS), dtype=torch.uint8)
    bases, tile_words, masks = plain_wide.schedule_counts(
        l2, torch.zeros(1, dtype=torch.int32), 12)
    assert not bases.any() and not tile_words.any() and not masks.any()


WIDE = [
    # n, shards
    (300_000, 2),                        # 2 tiles
    (3 * TILE_BYTES - 5000, 8),          # 3 tiles, 5 padding shards
    (3 * TILE_BYTES - 5000, 2),          # 3 tiles, 1 padding tile
]


@pytest.mark.parametrize("n,k", WIDE)
def test_wide_equals_single_device(n, k):
    data = testdata.skewed(n, num_symbols=32, seed=31 + k)
    codec = cpu_codec(k)
    enc = codec.encode_wide(data)
    single = wide.encode_wide(data, device="cpu")
    assert len(enc.tile_words) == wide.num_tiles(n)
    assert container.dumps_wide(enc) == container.dumps_wide(single)
    np.testing.assert_array_equal(codec.decode_wide(enc), data)


def test_wide_equals_reference_at_pow2_tiles():
    # the one JAX interpret-mode call of this file
    data = testdata.skewed(300_000, num_symbols=32, seed=31)
    cb = Codebook.from_data(data, 12)
    enc = cpu_codec(2).encode_wide(data, codebook=cb)
    ref = RefShardedCodec(ref_make_mesh(2)).encode_wide(
        data, codebook=RefCodebook.from_lengths(cb.lengths), interpret=True)
    np.testing.assert_array_equal(enc.payload_words, ref.payload_words)
    np.testing.assert_array_equal(enc.tile_words, ref.tile_words)
    np.testing.assert_array_equal(enc.bases, ref.bases)


def test_wide_decode_fewer_tiles_than_shards():
    data = testdata.skewed(5_000, num_symbols=16, seed=33)
    enc = wide.encode_wide(data, device="cpu")
    np.testing.assert_array_equal(cpu_codec(8).decode_wide(enc), data)


@pytest.mark.parametrize("fmt", ["dense", "wide"])
def test_empty_input(fmt):
    codec = cpu_codec(4)
    if fmt == "dense":
        enc = codec.encode(b"")
        assert container.dumps(enc) == container.dumps(
            api.encode(b"", device="cpu"))
        assert codec.decode(enc).size == 0
    else:
        enc = codec.encode_wide(b"")
        assert container.dumps_wide(enc) == container.dumps_wide(
            wide.encode_wide(b"", device="cpu"))
        assert codec.decode_wide(enc).size == 0
