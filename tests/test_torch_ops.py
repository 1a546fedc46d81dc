"""The plain PyTorch versions of the port's kernels against huffman_tpu.

Each plain version (the CPU path of its kernel wrapper) is held bit for
bit (tolerance zero: integer codec) against the JAX package's XLA op and
its Pallas kernel run in interpret mode, on inputs made with numpy seeds.
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.
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
from huffman_tpu.ops import bitio as ref_bitio
from huffman_tpu.ops import encode as ref_encode
from huffman_tpu.ops import histogram as ref_hist
from huffman_tpu.ops import scan as ref_scan
from huffman_tpu.ops.pallas.encode import encode_blocks_pallas

from huffman_tpu_torch import codebook as port_cb
from huffman_tpu_torch.ops import bitio, histogram, scan
from huffman_tpu_torch.ops import encode as p_encode
from huffman_tpu_torch.ops.cuda import dense_decode as k_decode
from huffman_tpu_torch.ops.cuda import encode as k_encode
from huffman_tpu_torch.ops.cuda import pack2 as k_pack
from huffman_tpu_torch.utils import testdata


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _case(n, nsym, bb, seed, cap_bpb=8, mcl=12):
    """(data, blocks (NB, bb) u8, valid (NB,) i32, port codebook, cfg)."""
    data = testdata.skewed(n, num_symbols=nsym, seed=seed)
    cfg = RefConfig(block_bytes=bb, capacity_bits_per_byte=cap_bpb,
                    max_code_len=mcl)
    blocks, n = ref_api._as_blocks(data, cfg)
    valid = ref_api.valid_per_block(n, blocks.shape[0], bb)
    return data, blocks, valid, port_cb.Codebook.from_data(data, mcl), cfg


def _port_encode(blocks, valid, cb, cap):
    return k_encode.encode_blocks(
        torch.from_numpy(blocks), torch.from_numpy(cb.codes.view(np.int32)),
        torch.from_numpy(cb.lengths.astype(np.int32)),
        torch.from_numpy(valid), cap)


ENCODE_CASES = [
    (4 * 1024, 32, 1024, 0),
    (4 * 1024 + 321, 256, 1024, 1),   # partial final block
    (3000, 5, 128, 3),
    (1000, 2, 64, 4),                  # 16 words per block
    (1024, 1, 1024, 5),                # single-symbol codebook
]


@pytest.mark.parametrize("n,nsym,bb,seed", ENCODE_CASES)
def test_encode_vs_xla(n, nsym, bb, seed):
    data, blocks, valid, cb, cfg = _case(n, nsym, bb, seed)
    streams, bits = _port_encode(blocks, valid, cb, cfg.capacity_words)
    r_streams, r_bits = ref_encode.encode_blocks(
        jnp.asarray(blocks), jnp.asarray(cb.codes), jnp.asarray(cb.lengths),
        jnp.asarray(valid), cfg.capacity_words)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(r_bits))
    np.testing.assert_array_equal(_u32(streams), np.asarray(r_streams))


def test_encode_vs_pallas_interpret():
    data, blocks, valid, cb, cfg = _case(8 * 1024 + 13, 64, 1024, 7)
    streams, bits = _port_encode(blocks, valid, cb, 256)
    r_streams, r_bits = encode_blocks_pallas(
        jnp.asarray(blocks), jnp.asarray(cb.codes), jnp.asarray(cb.lengths),
        jnp.asarray(valid), 256, interpret=True)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(r_bits))
    np.testing.assert_array_equal(_u32(streams), np.asarray(r_streams))


def test_encode_miss_flag_vs_pallas():
    """A valid byte with no code sets bit 31 of its block's count, as the
    Pallas kernel's detect_missing does; the count stays exact."""
    data, blocks, valid, _, _ = _case(3 * 1024, 16, 1024, 9)
    freqs = port_cb.byte_histogram_host(data)
    freqs[data[2500]] = 0                   # block 2 holds a byte with no code
    cb = port_cb.Codebook.from_frequencies(freqs, 12)
    streams, bits = _port_encode(blocks, valid, cb, 256)
    _, r_bits = encode_blocks_pallas(
        jnp.asarray(blocks), jnp.asarray(cb.codes), jnp.asarray(cb.lengths),
        jnp.asarray(valid), 256, interpret=True, detect_missing=True)
    got = bits.numpy().view(np.uint32)
    want = np.asarray(r_bits).view(np.uint32)
    np.testing.assert_array_equal(got >> 31, want >> 31)
    assert (got >> 31).any()
    np.testing.assert_array_equal(got & p_encode.BITS_MASK,
                                  want & p_encode.BITS_MASK)


def _golden_block_words(block, cb):
    by, nbits = ref_golden.encode(block, RefCodebook.from_lengths(cb.lengths))
    return packed_bytes_to_words(by), nbits


def test_encode_exact_32bit_first_item():
    """A 4-byte group of exactly 32 bits (four 8-bit codes) at a word
    boundary: the shift-by-32 edge of tests/test_compact16.py's regression."""
    lens = np.zeros(256, np.int32)
    lens[:8] = [8, 1, 2, 3, 5, 6, 7, 8]
    cb = port_cb.Codebook.from_lengths(lens)
    data = np.ones(2048, np.uint8)
    data[16:20] = 0
    data[1024 + 48: 1024 + 52] = 0
    data[1024 + 52] = 4
    blocks = data.reshape(2, 1024)
    valid = np.full(2, 1024, np.int32)
    streams, bits = _port_encode(blocks, valid, cb, 128)
    r_streams, r_bits = ref_encode.encode_blocks(
        jnp.asarray(blocks), jnp.asarray(cb.codes), jnp.asarray(cb.lengths),
        jnp.asarray(valid), 128)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(r_bits))
    np.testing.assert_array_equal(_u32(streams), np.asarray(r_streams))
    for b in range(2):
        words, nbits = _golden_block_words(blocks[b], cb)
        assert int(bits[b]) == nbits
        np.testing.assert_array_equal(_u32(streams)[b, : words.size], words)


def test_encode_24bit_codes_vs_xla_and_golden():
    """Codes of up to 24 bits: four of them make 96 bits per 4-byte group,
    more than one 64-bit accumulator holds."""
    lens = np.zeros(256, np.int32)
    lens[:25] = list(range(1, 25)) + [24]
    cb = port_cb.Codebook.from_lengths(lens)
    rng = np.random.default_rng(11)
    data = np.zeros(64 * 20 + 9, np.uint8)
    data[rng.integers(0, data.size, 300)] = rng.integers(1, 25, 300)
    data[64:68] = 24
    data[132:140] = 23
    cfg = RefConfig(block_bytes=64, max_code_len=24, capacity_bits_per_byte=24)
    blocks, n = ref_api._as_blocks(data, cfg)
    valid = ref_api.valid_per_block(n, blocks.shape[0], 64)
    streams, bits = _port_encode(blocks, valid, cb, cfg.capacity_words)
    r_streams, r_bits = ref_encode.encode_blocks(
        jnp.asarray(blocks), jnp.asarray(cb.codes), jnp.asarray(cb.lengths),
        jnp.asarray(valid), cfg.capacity_words)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(r_bits))
    np.testing.assert_array_equal(_u32(streams), np.asarray(r_streams))
    words, nbits = _golden_block_words(data[64:128], cb)
    assert int(bits[1]) == nbits
    np.testing.assert_array_equal(_u32(streams)[1, : words.size], words)


def _offsets(bits_np):
    return scan.exclusive_bit_offsets(torch.from_numpy(bits_np))


@pytest.mark.parametrize("n,n_valid", [(5000, None), (5000, 4321), (4096, 1)])
def test_histogram_vs_jax(n, n_valid):
    data = testdata.uniform_random(n, seed=n % 7).reshape(-1, 8)
    got = histogram.histogram(torch.from_numpy(data), n_valid).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(ref_hist.histogram_xla(jnp.asarray(data), n_valid)))
    np.testing.assert_array_equal(
        got, np.asarray(ref_hist.histogram(jnp.asarray(data), n_valid)))


@pytest.mark.parametrize("seed", [0, 1])
def test_scan_vs_jax(seed):
    bits = np.random.default_rng(seed).integers(0, 9000, 777).astype(np.int32)
    got = scan.exclusive_bit_offsets(torch.from_numpy(bits))
    ref = ref_scan.exclusive_bit_offsets(jnp.asarray(bits))
    np.testing.assert_array_equal(got.word_base.numpy(), np.asarray(ref.word_base))
    np.testing.assert_array_equal(got.bit_shift.numpy(), np.asarray(ref.bit_shift))
    assert int(got.total_words) == int(ref.total_words)
    assert int(got.total_bits) == ref_scan.total_bits_host(ref)


def test_bitio_vs_jax():
    """Every shift amount from -1 to 64, including the undefined-on-card
    32-bit edge, on random words."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 32, size=66, dtype=np.uint32)
    y = rng.integers(0, 1 << 32, size=66, dtype=np.uint32)
    n = np.arange(-1, 65, dtype=np.int32)
    s = np.arange(66, dtype=np.int32) % 32
    tx, ty, tn, ts = (torch.from_numpy(a.astype(np.int64)) for a in (x, y, n, s))
    jx, jy, jn, js = (jnp.asarray(a) for a in (x, y, n, s))
    for port_fn, ref_fn in ((bitio.safe_shl, ref_bitio.safe_shl),
                            (bitio.safe_shr, ref_bitio.safe_shr)):
        np.testing.assert_array_equal(port_fn(tx, tn).numpy(),
                                      np.asarray(ref_fn(jx, jn)))
    np.testing.assert_array_equal(
        bitio.extract_window(tx, ty, ts).numpy(),
        np.asarray(ref_bitio.extract_window(jx, jy, js)))
    np.testing.assert_array_equal(
        bitio.shift_word_stream(tx, ty, ts).numpy(),
        np.asarray(ref_bitio.shift_word_stream(jx, jy, js)))
    code = rng.integers(0, 1 << 24, size=66).astype(np.uint32)
    length = (np.arange(66) % 25).astype(np.int32)
    code &= ((1 << length.astype(np.int64)) - 1).astype(np.uint32)
    p0, p1 = bitio.code_word_parts(torch.from_numpy(code.astype(np.int64)),
                                   torch.from_numpy(length.astype(np.int64)),
                                   ts)
    r0, r1 = ref_bitio.code_word_parts(jnp.asarray(code), jnp.asarray(length),
                                       js)
    np.testing.assert_array_equal(p0.numpy(), np.asarray(r0))
    np.testing.assert_array_equal(p1.numpy(), np.asarray(r1))
    i32 = bitio.to_i32(tx)
    assert i32.dtype == torch.int32
    np.testing.assert_array_equal(bitio.to_u32(i32).numpy(), x)


def test_wrappers_take_plain_version_only_on_cpu():
    """CPU tensors: the wrapper's result is the plain version's and no
    launch is counted.  Other devices raise; nothing falls back."""
    data, blocks, valid, cb, cfg = _case(2048, 16, 1024, 1)
    before = (k_encode.launches.n, k_pack.launches.n, k_decode.launches.n)
    streams, bits = _port_encode(blocks, valid, cb, 256)
    s2, b2 = p_encode.encode_blocks(
        torch.from_numpy(blocks), torch.from_numpy(cb.codes.view(np.int32)),
        torch.from_numpy(cb.lengths.astype(np.int32)),
        torch.from_numpy(valid), 256)
    assert torch.equal(streams, s2) and torch.equal(bits, b2)
    offs = _offsets(bits.numpy())
    k_pack.pack_blocks(streams, bits, offs.word_base, offs.bit_shift,
                       int(offs.total_words))
    assert (k_encode.launches.n, k_pack.launches.n, k_decode.launches.n) == before
    meta = torch.empty((2, 1024), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k_encode.encode_blocks(meta, meta, meta, meta, 256)
    with pytest.raises(ValueError, match="unsupported device"):
        k_pack.pack_blocks(meta, meta, meta, meta, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        k_decode.decode_blocks(meta, meta, meta, meta, meta, 8, 1024)
