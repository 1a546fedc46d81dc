"""The port's dense slice end to end on CPU, against huffman_tpu.

api.encode (device="cpu": the kernel wrappers run their plain versions)
against huffman_tpu.api.encode and the golden codec; decode and
decode_range; identical .htz v1 bytes, loaded by either package; state
conversion; the error contract; the CLI; and the import boundary (the port
never imports jax or huffman_tpu).  Tolerance zero throughout.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from huffman_tpu import api as ref_api
from huffman_tpu import container as ref_container
from huffman_tpu import golden as ref_golden
from huffman_tpu.codebook import Codebook as RefCodebook
from huffman_tpu.config import CodecConfig as RefConfig
from huffman_tpu.golden.numpy_codec import packed_bytes_to_words

from huffman_tpu_torch import api, cli, container, convert, wide
from huffman_tpu_torch.codebook import Codebook
from huffman_tpu_torch.config import CodecConfig
from huffman_tpu_torch.utils import testdata
from huffman_tpu_torch.verify import verify_encoded, verify_roundtrip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = [
    # n, nsym, block_bytes, seed
    (10 * 1024 + 77, 32, 1024, 0),     # partial final block
    (6 * 1024, 256, 1024, 1),
    (3000, 5, 128, 2),
    (777, 2, 64, 3),
    (1, 1, 1024, 4),                   # one byte, one-symbol codebook
]


def _pair(n, nsym, bb, seed):
    data = testdata.skewed(n, num_symbols=nsym, seed=seed)
    return (data, api.encode(data, CodecConfig(block_bytes=bb), device="cpu"),
            ref_api.encode(data, RefConfig(block_bytes=bb)))


@pytest.mark.parametrize("n,nsym,bb,seed", CASES)
def test_encode_equals_reference_and_golden(n, nsym, bb, seed):
    data, enc, ref = _pair(n, nsym, bb, seed)
    np.testing.assert_array_equal(enc.codebook.lengths, ref.codebook.lengths)
    np.testing.assert_array_equal(enc.codebook.codes, ref.codebook.codes)
    assert enc.total_bits == ref.total_bits
    np.testing.assert_array_equal(enc.block_bits, ref.block_bits)
    np.testing.assert_array_equal(enc.stream_words, ref.stream_words)
    assert enc.stream_words.dtype == np.uint32
    g_bytes, g_bits = ref_golden.encode(data, RefCodebook.from_lengths(
        enc.codebook.lengths))
    assert g_bits == enc.total_bits
    np.testing.assert_array_equal(enc.stream_words,
                                  packed_bytes_to_words(g_bytes))
    assert verify_encoded(enc, data)
    np.testing.assert_array_equal(enc.stream_bytes, g_bytes)


@pytest.mark.parametrize("n,nsym,bb,seed", CASES)
def test_decode_and_range(n, nsym, bb, seed):
    data, enc, ref = _pair(n, nsym, bb, seed)
    np.testing.assert_array_equal(api.decode(enc, device="cpu"), data)
    assert verify_roundtrip(enc, data, device="cpu")
    for a, b in [(0, n), (n // 3, n - n // 4), (bb - 1, min(n, 2 * bb + 5)),
                 (n, n)]:
        if a <= b:
            np.testing.assert_array_equal(
                api.decode_range(enc, a, b, device="cpu"), data[a:b])
    assert api.roundtrip_ok(data, CodecConfig(block_bytes=bb), device="cpu")


@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("n,nsym,bb,seed", CASES[:3])
def test_container_bytes_identical_and_cross_load(n, nsym, bb, seed, checksum):
    data, enc, ref = _pair(n, nsym, bb, seed)
    blob = container.dumps(enc, checksum=checksum)
    assert blob == ref_container.dumps(ref, checksum=checksum)
    # port file -> JAX package, JAX file -> port
    np.testing.assert_array_equal(ref_api.decode(ref_container.loads(blob)),
                                  data)
    back = container.loads(ref_container.dumps(ref, checksum=checksum))
    np.testing.assert_array_equal(api.decode(back, device="cpu"), data)
    assert container.container_version(blob) == 1


def test_container_files_and_errors(tmp_path):
    data, enc, _ = _pair(5000, 16, 1024, 5)
    path = str(tmp_path / "x.htz")
    size = container.dump(enc, path)
    assert size == os.path.getsize(path)
    np.testing.assert_array_equal(
        api.decode(container.load(path), device="cpu"), data)
    blob = bytearray(container.dumps(enc))
    blob[-7] ^= 0x40                          # payload bit flip
    with pytest.raises(ValueError, match="CRC mismatch"):
        container.loads(bytes(blob))
    with pytest.raises(ValueError, match="truncated"):
        container.loads(container.dumps(enc)[:-9])
    with pytest.raises(ValueError, match="not an HTZ"):
        container.loads(b"nope" * 20)
    # version 3, the wide format: load() takes either version by its header
    wide_path = str(tmp_path / "w.htz")
    container.dump(wide.encode_wide(data, device="cpu"), wide_path)
    back = container.load(wide_path)
    assert isinstance(back, wide.WideEncoded)
    np.testing.assert_array_equal(wide.decode_wide(back, device="cpu"), data)
    with pytest.raises(ValueError, match="unsupported container version 3"):
        container.loads(open(wide_path, "rb").read())


def test_convert_round_trips():
    data, enc, ref = _pair(4 * 1024 + 9, 32, 1024, 6)
    # JAX package state -> port: decodes to the input
    cb = convert.codebook_from_fields(ref.codebook.codes,
                                      ref.codebook.lengths,
                                      ref.codebook.max_len)
    moved = convert.encoded_from_fields(
        ref.stream_words, ref.total_bits, ref.block_bits, ref.n_bytes,
        ref.config.block_bytes, ref.config.max_code_len, cb)
    np.testing.assert_array_equal(api.decode(moved, device="cpu"), data)
    assert container.dumps(moved) == ref_container.dumps(ref)
    # port state -> JAX package: decodes to the input
    f = convert.encoded_fields(enc)
    c = convert.codebook_fields(enc.codebook)
    ref_enc = ref_api.Encoded(
        stream_words=f["stream_words"], total_bits=f["total_bits"],
        block_bits=f["block_bits"], codebook=RefCodebook.from_lengths(
            c["lengths"]), n_bytes=f["n_bytes"],
        config=RefConfig(block_bytes=f["block_bytes"],
                         max_code_len=f["max_code_len"]))
    np.testing.assert_array_equal(ref_api.decode(ref_enc), data)
    np.testing.assert_array_equal(c["codes"], ref.codebook.codes)
    # and back again: the fields are unchanged
    again = convert.encoded_fields(convert.encoded_from_fields(
        **f, codebook=convert.codebook_from_fields(**c)))
    for k in f:
        np.testing.assert_array_equal(again[k], f[k])
    with pytest.raises(ValueError, match="canonical"):
        convert.codebook_from_fields(ref.codebook.codes[::-1],
                                     ref.codebook.lengths,
                                     ref.codebook.max_len)
    with pytest.raises(ValueError, match="total_bits"):
        convert.encoded_from_fields(**{**f, "total_bits": f["total_bits"] + 1},
                                    codebook=cb)


def test_explicit_codebook_missing_symbol_raises():
    data = testdata.skewed(3000, num_symbols=16, seed=7)
    freqs = np.bincount(data, minlength=256)
    freqs[data[2100]] = 0
    cb = Codebook.from_frequencies(freqs, 12)
    with pytest.raises(ValueError, match="absent from the codebook"):
        api.encode(data, codebook=cb, device="cpu")
    ref_cb = RefCodebook.from_frequencies(freqs, 12)
    with pytest.raises(ValueError, match="absent from the codebook"):
        ref_api.encode(data, codebook=ref_cb)


def test_explicit_codebook_equals_reference():
    lens = np.zeros(256, np.int32)
    lens[:4] = [1, 2, 14, 14]
    data = np.zeros(5000, np.uint8)
    data[::7], data[::13], data[::17] = 1, 2, 3
    cfg = CodecConfig(block_bytes=128, max_code_len=14)
    enc = api.encode(data, cfg, codebook=Codebook.from_lengths(lens),
                     device="cpu")
    ref = ref_api.encode(data, RefConfig(block_bytes=128, max_code_len=14),
                         codebook=RefCodebook.from_lengths(lens))
    np.testing.assert_array_equal(enc.stream_words, ref.stream_words)
    np.testing.assert_array_equal(api.decode(enc, device="cpu"), data)


def test_overflow_raises_like_reference():
    data = testdata.uniform_random(4096, seed=8)
    cfg = CodecConfig(capacity_bits_per_byte=4)
    with pytest.raises(OverflowError, match="raise config.capacity"):
        api.encode(data, cfg, device="cpu")
    with pytest.raises(OverflowError, match="raise config.capacity"):
        ref_api.encode(data, RefConfig(capacity_bits_per_byte=4))


def test_empty_input():
    enc = api.encode(b"", device="cpu")
    ref = ref_api.encode(b"")
    assert enc.total_bits == 0 and enc.n_bytes == 0
    np.testing.assert_array_equal(enc.block_bits, ref.block_bits)
    assert api.decode(enc, device="cpu").size == 0
    assert container.dumps(enc) == ref_container.dumps(ref)
    assert api.decode(container.loads(container.dumps(enc)),
                      device="cpu").size == 0
    with pytest.raises(ValueError, match="outside"):
        api.decode_range(enc, 0, 1, device="cpu")


def test_config_defaults_match_reference():
    a, b = CodecConfig(), RefConfig()
    for k in ("block_bytes", "max_code_len", "capacity_bits_per_byte",
              "check_overflow", "narrow_tol"):
        assert getattr(a, k) == getattr(b, k)
    assert a.capacity_words == b.capacity_words == 256
    for bad in ({"block_bytes": 6}, {"max_code_len": 25}):
        with pytest.raises(ValueError):
            CodecConfig(**bad)


def test_cli_roundtrip(tmp_path, capsys):
    data = testdata.skewed(9000, num_symbols=32, seed=9)
    src = tmp_path / "in.bin"
    src.write_bytes(data.tobytes())
    htz = str(tmp_path / "in.htz")
    assert cli.main(["encode", str(src), "-o", htz, "--verify",
                     "--device", "cpu"]) == 0
    assert "PASS" in capsys.readouterr().out
    out = str(tmp_path / "out.bin")
    assert cli.main(["decode", htz, "-o", out, "--device", "cpu"]) == 0
    assert open(out, "rb").read() == data.tobytes()
    assert cli.main(["decode", htz, "-o", out, "--range", "100:2500",
                     "--device", "cpu"]) == 0
    assert open(out, "rb").read() == data[100:2500].tobytes()
    assert cli.main(["roundtrip", str(src), "--device", "cpu"]) == 0
    # the JAX package reads the port's file
    np.testing.assert_array_equal(ref_api.decode(ref_container.load(htz)), data)
    # --format wide writes a v3 container that decode reads back
    assert cli.main(["encode", str(src), "-o", htz, "--format", "wide",
                     "--device", "cpu"]) == 0
    assert container.container_version(open(htz, "rb").read()) == 3
    assert cli.main(["decode", htz, "-o", out, "--device", "cpu"]) == 0
    assert open(out, "rb").read() == data.tobytes()
    # --mesh routes through the sharded codec
    assert cli.main(["decode", htz, "-o", out, "--mesh", "2",
                     "--device", "cpu"]) == 0
    assert open(out, "rb").read() == data.tobytes()


# every module of the port that a user or chip_smoke.py imports
PORT_MODULES = [
    "huffman_tpu_torch", "huffman_tpu_torch.api",
    "huffman_tpu_torch.transfer",
    "huffman_tpu_torch.container", "huffman_tpu_torch.cli",
    "huffman_tpu_torch.convert", "huffman_tpu_torch.verify",
    "huffman_tpu_torch.ops.cuda.encode",
    "huffman_tpu_torch.ops.cuda.pack2",
    "huffman_tpu_torch.ops.cuda.dense_decode",
    "huffman_tpu_torch.ops.cuda.histogram",
    "huffman_tpu_torch.ops.cuda.scan",
    "huffman_tpu_torch.ops.cuda.crc32",
    "huffman_tpu_torch.wide", "huffman_tpu_torch.ops.wide",
    "huffman_tpu_torch.golden", "huffman_tpu_torch.golden.wide_codec",
    "huffman_tpu_torch.ops.cuda.wide_encode",
    "huffman_tpu_torch.ops.cuda.wide_emit",
    "huffman_tpu_torch.ops.cuda.wide_decode",
    "huffman_tpu_torch.utils.testdata",
    "huffman_tpu_torch.parallel.mesh",
    "huffman_tpu_torch.parallel.pipeline",
    "huffman_tpu_torch.models", "huffman_tpu_torch.models.base",
    "huffman_tpu_torch.models.fixed",
    "huffman_tpu_torch.models.huffman",
    "huffman_tpu_torch.utils.device",
    "huffman_tpu_torch.utils.timing",
    "huffman_tpu_torch.utils.stats",
    "huffman_tpu_torch.utils.printers"]


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys\n" + "".join(f"import {m}\n" for m in PORT_MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'huffman_tpu'))\n"
            + "assert not bad, bad\nprint('clean')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"
