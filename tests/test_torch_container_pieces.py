"""The host container's pieces path on the CPU, against huffman_tpu.

container._piece_count is patched to force 1, 2, 3 or 8 pieces on small
payloads, as test_torch_host_pool.py patches transfer._host_block_path: the
v1 and v3 bytes equal the JAX package's byte for byte, with the checksum on
and off and word counts that no piece count divides; either package loads
the other's containers; loads and loads_wide raise as in one piece.  The
pieces' CRCs join to zlib.crc32 exactly (ops/crc32.crc32_combine), the
pool is made again in a forked child, and callers on many threads keep
their own payloads.
"""

import sys
import threading
import zlib

import numpy as np
import pytest

from huffman_tpu import api as ref_api
from huffman_tpu import container as ref_container
from huffman_tpu import wide as ref_wide
from huffman_tpu.codebook import Codebook as RefCodebook
from huffman_tpu.config import CodecConfig as RefConfig

from huffman_tpu_torch import api, container, wide
from huffman_tpu_torch.ops.crc32 import crc32_combine
from huffman_tpu_torch.utils import testdata

PIECES = [1, 2, 3, 8]
FORMATS = {
    # format: (dumps, loads, the JAX package's dumps, loads)
    "dense": (container.dumps, container.loads, ref_container.dumps,
              ref_container.loads),
    "wide": (container.dumps_wide, container.loads_wide,
             ref_container.dumps_wide, ref_container.loads_wide),
}


@pytest.fixture(scope="module")
def pairs():
    """{format: (data, the port's state, the JAX package's)}, each payload
    a word count that neither 3 nor 8 divides."""
    data = testdata.skewed(10 * 1024 + 77, num_symbols=32, seed=0)
    dense = api.encode(data, device="cpu")
    wdata = testdata.skewed(2 * wide.TILE_BYTES - 1000, num_symbols=40,
                            seed=1)
    wenc = wide.encode_wide(wdata, device="cpu")
    wref = ref_wide.WideEncoded(
        wenc.payload_words, wenc.tile_words, wenc.bases,
        RefCodebook.from_lengths(wenc.codebook.lengths), wenc.n_bytes,
        RefConfig(max_code_len=wenc.config.max_code_len))
    out = {"dense": (data, dense, ref_api.encode(data)),
           "wide": (wdata, wenc, wref)}
    for name, words in (("dense", dense.stream_words.size),
                        ("wide", wenc.payload_words.size)):
        assert words % 3 and words % 8, (name, words)
    return out


@pytest.fixture
def pieces(monkeypatch):
    """force(k): every payload is worked in k pieces."""
    def force(k: int) -> None:
        monkeypatch.setattr(container, "_piece_count", lambda nbytes: k)
    return force


def _decode(fmt, enc):
    return (api.decode(enc, device="cpu") if fmt == "dense"
            else wide.decode_wide(enc, device="cpu"))


def _ref_fields(fmt, enc) -> tuple:
    if fmt == "dense":
        return enc.stream_words, enc.block_bits, enc.total_bits
    return enc.payload_words, enc.tile_words, enc.bases


@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("k", PIECES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_dumps_equal_the_reference_in_pieces(pairs, pieces, fmt, k,
                                             checksum):
    _, enc, ref = pairs[fmt]
    dumps, _, ref_dumps, _ = FORMATS[fmt]
    pieces(k)
    blob = dumps(enc, checksum=checksum)
    assert type(blob) is bytes
    assert blob == ref_dumps(ref, checksum=checksum)


@pytest.mark.parametrize("k", PIECES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_packages_load_each_others_containers_in_pieces(pairs, pieces, fmt,
                                                        k):
    data, enc, ref = pairs[fmt]
    dumps, loads, ref_dumps, ref_loads = FORMATS[fmt]
    pieces(k)
    back = loads(ref_dumps(ref))                # JAX file -> port
    for got, want in zip(_ref_fields(fmt, back), _ref_fields(fmt, enc)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_decode(fmt, back), data)
    theirs = ref_loads(dumps(enc))              # port file -> JAX package
    for got, want in zip(_ref_fields(fmt, theirs), _ref_fields(fmt, enc)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", PIECES[1:])
@pytest.mark.parametrize("fmt", FORMATS)
def test_loads_raise_in_pieces(pairs, pieces, fmt, k):
    """test_torch_api.py::test_container_files_and_errors' cases, with a
    bit flipped in the first, a middle and the last payload byte."""
    _, enc, _ = pairs[fmt]
    dumps, loads, _, _ = FORMATS[fmt]
    pieces(k)
    blob = dumps(enc)
    payload = 4 * _ref_fields(fmt, enc)[0].size
    start = len(blob) - 4 - payload
    for at in (start, start + payload // 2, len(blob) - 5):
        bad = bytearray(blob)
        bad[at] ^= 0x40
        with pytest.raises(ValueError, match="CRC mismatch"):
            loads(bytes(bad))
    with pytest.raises(ValueError, match="truncated"):
        loads(blob[:-9])
    with pytest.raises(ValueError, match="not an HTZ"):
        loads(b"nope" * 20)


@pytest.mark.parametrize("k", [1, 3])
def test_loads_wide_reads_bytes_in_place_and_copies_other_buffers(
        pairs, pieces, k):
    data, enc, _ = pairs["wide"]
    pieces(k)
    blob = container.dumps_wide(enc)
    kept = container.loads_wide(blob)
    assert np.shares_memory(kept.payload_words, np.frombuffer(blob, np.uint8))
    assert not kept.payload_words.flags.writeable
    mutable = bytearray(blob)
    copied = container.loads_wide(mutable)
    assert copied.payload_words.flags.writeable
    mutable[-5] ^= 0xFF                         # after the load: no effect
    for back in (kept, copied):
        np.testing.assert_array_equal(back.payload_words, enc.payload_words)
        np.testing.assert_array_equal(
            wide.decode_wide(back, device="cpu"), data)


@pytest.fixture(scope="module")
def crc_data():
    rng = np.random.default_rng(5)
    return {n: rng.bytes(n) for n in (0, 1, 3, 4097, 64 * 2**20 + 3)}


@pytest.mark.parametrize("value", [0, 0xDEADBEEF])
@pytest.mark.parametrize("n", [0, 1, 3, 4097, 64 * 2**20 + 3])
def test_crc_of_random_splits_joins_to_zlibs(crc_data, n, value):
    data = crc_data[n]
    want = zlib.crc32(data, value)
    rng = np.random.default_rng(n + value)
    for cuts in range(6):                       # 1 to 6 uneven pieces,
        bounds = [0, *sorted(rng.integers(0, n + 1, cuts).tolist()), n]
        crc = value                             # empty ones among them
        for a, b in zip(bounds, bounds[1:]):
            crc = crc32_combine(crc, zlib.crc32(data[a:b]), b - a)
        assert crc == want, bounds
        crc = container._crc32(data, bounds)    # pieces on the workers
        assert crc32_combine(value, crc, n) == want, bounds


def test_the_pool_is_made_again_in_a_forked_child(monkeypatch):
    pool = container._workers()
    assert container._workers() is pool
    monkeypatch.setattr(container.os, "getpid", lambda: -1)
    child = container._workers()
    assert child is not pool and container._workers() is child
    assert child.submit(lambda: 7).result(timeout=60) == 7


def test_concurrent_callers_keep_their_own_payloads(pairs, pieces):
    """Sixteen threads dump and load their own streams in three pieces at
    a short switch interval: a payload buffer or a piece shared between
    callers would mix their bytes."""
    _, enc, ref = pairs["dense"]
    pieces(3)
    streams = [np.roll(enc.stream_words, t) for t in range(16)]
    encs = [api.Encoded(stream_words=s, total_bits=enc.total_bits,
                        block_bits=enc.block_bits, codebook=enc.codebook,
                        n_bytes=enc.n_bytes, config=enc.config)
            for s in streams]
    want = [ref_container.dumps(ref_api.Encoded(
        stream_words=s, total_bits=ref.total_bits, block_bits=ref.block_bits,
        codebook=ref.codebook, n_bytes=ref.n_bytes, config=ref.config))
        for s in streams]
    errors, done = [], []

    def worker(tid: int):
        for i in range(20):
            blob = container.dumps(encs[tid])
            back = container.loads(blob)
            if blob != want[tid] or not np.array_equal(back.stream_words,
                                                       streams[tid]):
                errors.append((tid, i))
        done.append(tid)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == list(range(16)) and errors == []
