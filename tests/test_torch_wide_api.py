"""The port's wide slice end to end on CPU, against huffman_tpu.

wide.encode_wide / decode_wide / decode_wide_range (device="cpu": the
kernel wrappers run their plain versions) against the format's
specification (golden/wide_codec.py); .htz v3 bytes identical to the JAX
package's writer at a power-of-two tile count, and read by either package
(including the JAX encoder's padded tile count); state conversion; the
error contract; and the CLI.  Tolerance zero throughout.
"""

import numpy as np
import pytest

from huffman_tpu import container as ref_container
from huffman_tpu import wide as ref_wide
from huffman_tpu.codebook import Codebook as RefCodebook
from huffman_tpu.config import CodecConfig as RefConfig

from huffman_tpu_torch import api, cli, container, convert, wide
from huffman_tpu_torch.codebook import Codebook
from huffman_tpu_torch.config import CodecConfig
from huffman_tpu_torch.golden import wide_codec as W
from huffman_tpu_torch.utils import testdata

TILE = W.TILE_BYTES


def golden_fields(data, cb):
    tiles, _ = W.encode(data, cb.codes, cb.lengths)
    payload = np.concatenate([np.concatenate([p0, p1]) for p0, p1, _ in tiles])
    return (payload, np.array([p0.size for p0, _, _ in tiles], np.int32),
            np.stack([b for _, _, b in tiles]).astype(np.int32))


def spec_decode(enc):
    """The specification's reader over a WideEncoded of either package."""
    starts = np.concatenate([[0], np.cumsum(2 * enc.tile_words.astype(
        np.int64))])
    tiles = [(enc.payload_words[s: s + w], enc.payload_words[s + w: s + 2 * w],
              b) for s, w, b in zip(starts, enc.tile_words, enc.bases)]
    mcl = int(enc.codebook.lengths.max(initial=1)) or 1
    syms, lens = enc.codebook.decode_table(mcl)
    return W.decode(tiles, enc.n_bytes, syms, lens, mcl, mcl)


def to_ref(enc) -> ref_wide.WideEncoded:
    return ref_wide.WideEncoded(
        enc.payload_words, enc.tile_words, enc.bases,
        RefCodebook.from_lengths(enc.codebook.lengths), enc.n_bytes,
        RefConfig(max_code_len=enc.config.max_code_len))


API_CASES = [
    # n, nsym, max_code_len, seed
    (2 * TILE - 1000, 32, 12, 0),     # partial second tile
    (3 * TILE + 5, 64, 12, 1),        # 4 tiles, 5 bytes in the last
    (20000, 6, 8, 2),                 # narrow book, one partial tile
]


@pytest.mark.parametrize("n,nsym,mcap,seed", API_CASES)
def test_encode_decode_and_range_equal_spec(n, nsym, mcap, seed):
    data = testdata.skewed(n, num_symbols=nsym, seed=seed)
    cfg = CodecConfig(max_code_len=mcap)
    enc = wide.encode_wide(data, cfg, device="cpu")
    # the codebook is the exact one of the dense path (same cap policy)
    np.testing.assert_array_equal(
        enc.codebook.lengths, api.build_codebook(data, cfg, "cpu").lengths)
    payload, tw, bases = golden_fields(data, enc.codebook)
    np.testing.assert_array_equal(enc.tile_words, tw)
    np.testing.assert_array_equal(enc.bases, bases)
    np.testing.assert_array_equal(enc.payload_words, payload)
    assert enc.payload_words.dtype == np.uint32
    assert len(enc.tile_words) == wide.num_tiles(n)
    assert enc.ratio == payload.size * 4 / n
    np.testing.assert_array_equal(wide.decode_wide(enc, device="cpu"), data)
    for a, b in [(0, n), (min(n, TILE) - 10, min(n, TILE + 10)), (n - 1, n),
                 (7, 7), (n // 3, n - n // 5)]:
        np.testing.assert_array_equal(
            wide.decode_wide_range(enc, a, b, device="cpu"), data[a:b])
    with pytest.raises(ValueError, match="outside"):
        wide.decode_wide_range(enc, 0, n + 1, device="cpu")


@pytest.mark.parametrize("checksum", [True, False])
def test_container_bytes_identical_at_pow2_tiles(checksum):
    data = testdata.skewed(2 * TILE - 77, num_symbols=20, seed=3)
    enc = wide.encode_wide(data, device="cpu")
    ref = to_ref(enc)
    blob = container.dumps_wide(enc, checksum=checksum)
    assert blob == ref_container.dumps_wide(ref, checksum=checksum)
    assert container.container_version(blob) == container.WIDE_VERSION == 3
    back = container.loads_wide(blob)
    for k in ("payload_words", "tile_words", "bases"):
        np.testing.assert_array_equal(getattr(back, k), getattr(enc, k))
    np.testing.assert_array_equal(wide.decode_wide(back, device="cpu"), data)


def test_port_3_tile_container_read_by_reference(tmp_path):
    data = testdata.skewed(3 * TILE - 5000, num_symbols=40, seed=4)
    enc = wide.encode_wide(data, device="cpu")
    assert len(enc.tile_words) == 3
    path = str(tmp_path / "w.htz")
    assert container.dump(enc, path) == len(container.dumps_wide(enc))
    ref = ref_container.load(path)
    assert isinstance(ref, ref_wide.WideEncoded) and len(ref.tile_words) == 3
    np.testing.assert_array_equal(spec_decode(ref), data)
    np.testing.assert_array_equal(
        wide.decode_wide(container.load(path), device="cpu"), data)


def test_reference_padded_container_read_by_port():
    """The JAX encoder rounds the tile count up to a power of two: 3 tiles
    of data give 4 tiles, the last empty.  The port writes 3 tiles, equal
    to the JAX package's first 3, and reads the padded container."""
    data = testdata.skewed(3 * TILE - 5000, num_symbols=24, seed=5)
    cb = RefCodebook.from_data(data, 12)
    ref = ref_wide.encode_wide(data, RefConfig(), codebook=cb, interpret=True)
    assert list(ref.tile_words[3:]) == [0] and len(ref.tile_words) == 4
    back = container.loads_wide(ref_container.dumps_wide(ref))
    assert len(back.tile_words) == 4
    np.testing.assert_array_equal(wide.decode_wide(back, device="cpu"), data)
    np.testing.assert_array_equal(
        wide.decode_wide_range(back, TILE - 3, 3 * TILE - 5000, device="cpu"),
        data[TILE - 3:])
    mine = wide.encode_wide(data, codebook=Codebook.from_lengths(cb.lengths),
                            device="cpu")
    np.testing.assert_array_equal(mine.tile_words, ref.tile_words[:3])
    np.testing.assert_array_equal(mine.bases, ref.bases[:3])
    np.testing.assert_array_equal(mine.payload_words, ref.payload_words)


def test_container_errors():
    data = testdata.skewed(30000, num_symbols=16, seed=6)
    enc = wide.encode_wide(data, device="cpu")
    blob = container.dumps_wide(enc)
    bad = bytearray(blob)
    bad[-9] ^= 0x10                             # payload bit flip
    with pytest.raises(ValueError, match="CRC mismatch"):
        container.loads_wide(bytes(bad))
    with pytest.raises(ValueError, match="truncated"):
        container.loads_wide(blob[:-11])
    with pytest.raises(ValueError, match="not a version-3"):
        container.loads_wide(container.dumps(api.encode(data, device="cpu")))
    with pytest.raises(ValueError, match="unsupported container version 3"):
        container.loads(blob)
    tile = bytearray(blob)
    tile[20:24] = (1024).to_bytes(4, "little")  # block_bytes := tile size
    with pytest.raises(ValueError, match="tile size"):
        container.loads_wide(bytes(tile))
    mcl = bytearray(blob)
    mcl[24:28] = (13).to_bytes(4, "little")
    with pytest.raises(ValueError, match="max_code_len"):
        container.loads_wide(bytes(mcl))
    lens = bytearray(blob)
    lens[40 + 3] = 13                           # symbol 3's code length
    with pytest.raises(ValueError, match="13-bit codes"):
        container.loads_wide(bytes(lens))
    with pytest.raises(ValueError, match="bases shape"):
        container.dumps_wide(wide.WideEncoded(
            enc.payload_words, enc.tile_words, enc.bases[:, :10],
            enc.codebook, enc.n_bytes, enc.config))


def test_convert_round_trips():
    data = testdata.skewed(TILE + 4321, num_symbols=32, seed=7)
    enc = wide.encode_wide(data, device="cpu")
    # port state -> JAX package fields: the spec reader decodes them
    f = convert.wide_encoded_fields(enc)
    c = convert.codebook_fields(enc.codebook)
    ref = ref_wide.WideEncoded(
        f["payload_words"], f["tile_words"], f["bases"],
        RefCodebook.from_lengths(c["lengths"]), f["n_bytes"],
        RefConfig(max_code_len=f["max_code_len"]))
    np.testing.assert_array_equal(spec_decode(ref), data)
    assert ref_container.dumps_wide(ref) == container.dumps_wide(enc)
    # JAX package state -> port: decodes to the input
    moved = convert.wide_encoded_from_fields(
        ref.payload_words, ref.tile_words, ref.bases, ref.n_bytes,
        ref.config.max_code_len, convert.codebook_from_fields(
            ref.codebook.codes, ref.codebook.lengths, ref.codebook.max_len))
    np.testing.assert_array_equal(wide.decode_wide(moved, device="cpu"), data)
    again = convert.wide_encoded_fields(moved)
    for k in f:
        np.testing.assert_array_equal(again[k], f[k])
    with pytest.raises(ValueError, match="payload_words"):
        convert.wide_encoded_from_fields(**{**f, "payload_words":
                                            f["payload_words"][:-1]},
                                         codebook=enc.codebook)
    with pytest.raises(ValueError, match="bases shape"):
        convert.wide_encoded_from_fields(**{**f, "bases": f["bases"][:, 1:]},
                                         codebook=enc.codebook)


def test_error_contract_and_empty_input():
    data = testdata.skewed(5000, num_symbols=16, seed=8)
    with pytest.raises(ValueError, match="max_code_len <= 12"):
        wide.encode_wide(data, CodecConfig(max_code_len=13), device="cpu")
    with pytest.raises(ValueError, match="requires a TPU|max_code_len <= 12"):
        ref_wide.encode_wide(data, RefConfig(max_code_len=13))
    lens = np.zeros(256, np.int32)
    lens[:14] = list(range(1, 14)) + [13]
    with pytest.raises(ValueError, match="at most 12"):
        wide.encode_wide(data, codebook=Codebook.from_lengths(lens),
                         device="cpu")
    freqs = np.bincount(data, minlength=256)
    freqs[data[4000]] = 0
    with pytest.raises(ValueError, match="absent from the codebook"):
        wide.encode_wide(data, codebook=Codebook.from_frequencies(freqs, 12),
                         device="cpu")
    enc = wide.encode_wide(b"", device="cpu")
    assert enc.n_bytes == 0 and enc.payload_words.size == 0
    np.testing.assert_array_equal(enc.tile_words, [0])
    assert enc.bases.shape == (1, W.ROUNDS) and not enc.bases.any()
    payload, tw, bases = golden_fields(np.zeros(0, np.uint8), enc.codebook)
    np.testing.assert_array_equal(enc.tile_words, tw)
    assert wide.decode_wide(enc, device="cpu").size == 0
    back = container.loads_wide(container.dumps_wide(enc))
    assert wide.decode_wide(back, device="cpu").size == 0
    assert wide.decode_wide_range(back, 0, 0, device="cpu").size == 0


def test_cli_wide_roundtrip(tmp_path, capsys):
    data = testdata.skewed(TILE + 9000, num_symbols=32, seed=9)
    src = tmp_path / "in.bin"
    src.write_bytes(data.tobytes())
    htz = str(tmp_path / "in.htz")
    assert cli.main(["encode", str(src), "-o", htz, "--format", "wide",
                     "--verify", "--device", "cpu"]) == 0
    assert "verify roundtrip: PASS" in capsys.readouterr().out
    with open(htz, "rb") as f:
        assert container.container_version(f.read()) == 3
    out = str(tmp_path / "out.bin")
    assert cli.main(["decode", htz, "-o", out, "--device", "cpu"]) == 0
    assert open(out, "rb").read() == data.tobytes()
    assert cli.main(["decode", htz, "-o", out, "--range",
                     f"{TILE - 100}:{TILE + 2500}", "--device", "cpu"]) == 0
    assert open(out, "rb").read() == data[TILE - 100: TILE + 2500].tobytes()
    # the JAX package reads the port's file
    np.testing.assert_array_equal(spec_decode(ref_container.load(htz)), data)
    # auto resolves to dense, as the JAX package's CLI does off a TPU
    assert cli.main(["encode", str(src), "-o", htz, "--device", "cpu"]) == 0
    with open(htz, "rb") as f:
        assert container.container_version(f.read()) == 1
