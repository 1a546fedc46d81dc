"""bf16 tensors coded DFloat11's way, on the CPU, with the kernel path
patched on (the CUDA kernels' plain versions run on CPU tensors), as
tests/test_torch_device_path.py does: api.encode of a bf16 tensor splits
it into an exponent plane, encoded as a uint8 tensor is, and a raw
sign-mantissa plane (api.PlanesEncoded); container.dumps_device and
loads_device write and read them as a container version 4; api.decode
merges them back.

The plain split and merge equal the benchmark's reference, every bit
pattern comes back (signed zeros, subnormals, infinities, NaN payloads),
a view off a 16-byte address is read in place, the v4 container equals
the reference's sections and its exponent part equals the v1 container
of the exponent plane, loads_device refuses what it must, the spans are
recorded, and the cell df11.nemotron-h-47b-mlp runs correct at a small
size through the harness, and not correct with a fault planted in the
plane or in the output.
"""

import copy
import functools
import math
import sys
import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from huffman_tpu_torch import api, container, transfer
from huffman_tpu_torch.codebook import Codebook
from huffman_tpu_torch.ops import planes as plane_ops
from huffman_tpu_torch.ops.cuda import crc32 as k_crc
from huffman_tpu_torch.ops.cuda import planes as k_planes
from huffman_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch import check, gen, harness  # noqa: E402
from bench_torch.reference import df11 as ref_df11  # noqa: E402

CELL = "df11.nemotron-h-47b-mlp"
SEED = 3_000_000_019
SAMPLE_MIN = 64 << 10
HEAD = 40 + 256                 # the header and the code lengths

# bit patterns: +-0, subnormals, +-1, the largest finite, +-inf, quiet and
# signalling NaNs with payloads, and the all-ones word
SPECIAL = [0x0000, 0x8000, 0x0001, 0x8001, 0x007F, 0x807F, 0x0080, 0x3F80,
           0xBF80, 0x7F7F, 0xFF7F, 0x7F80, 0xFF80, 0x7FC0, 0xFFC0, 0x7FC1,
           0x7F81, 0xFFA5, 0x7FFF, 0xFFFF]


def _words(values) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, np.uint16).view(np.int16)
                            .copy()).view(torch.bfloat16)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16)


@functools.lru_cache(maxsize=None)
def _gaussian(n: int, seed: int = SEED) -> np.ndarray:
    """n bf16 words of the cell's profile, as int16 bit patterns."""
    traffic = harness.Cell(CELL).traffic | {"bytes": 2 * n}
    return gen.generate(traffic, seed, "cpu").view(torch.int16).numpy()


def _case(name: str) -> torch.Tensor:
    if name == "special":
        rng = np.random.default_rng(1)
        return _words(rng.permutation(np.repeat(SPECIAL, 205)))
    if name == "every_word":
        return _words(np.arange(1 << 16))
    if name == "one_exponent":
        # exponent 127 throughout (1.0 <= |x| < 2), every sign and mantissa
        m = np.arange(4099) % 256
        return _words(((m & 0x80) << 8) | (127 << 7) | (m & 0x7F))
    if name == "empty":
        return torch.zeros(0, dtype=torch.bfloat16)
    n = {"one": 1, "odd": 4097, "sampled": 300_001}[name]
    return torch.from_numpy(_gaussian(n)).clone().view(torch.bfloat16)


CASES = ["empty", "one", "odd", "special", "every_word", "one_exponent",
         "sampled"]
NONEMPTY = CASES[1:]


@pytest.fixture
def kernel_path(monkeypatch):
    monkeypatch.setattr(api, "_kernel_path", lambda device: True)
    monkeypatch.setattr(api, "SAMPLE_MIN_BYTES", SAMPLE_MIN)
    timing.clear()
    yield
    timing.clear()


def _roundtrip(x: torch.Tensor):
    """(PlanesEncoded, container, loaded, decoded) of the bf16 tensor x."""
    enc = api.encode(x, device="cpu")
    assert isinstance(enc, api.PlanesEncoded)
    buf = container.dumps_device(enc)
    back = container.loads_device(buf)
    assert isinstance(back, api.PlanesEncoded)
    return enc, buf, back, api.decode(back, device="cpu")


# the plain split and merge

@pytest.mark.parametrize("case", CASES)
def test_plain_split_is_the_references(case):
    x = _case(case)
    exponent, sign_mantissa = plane_ops.split_bf16_plain(x)
    want_e, want_s = ref_df11.split(x.view(torch.uint8))
    assert torch.equal(exponent, want_e)
    assert torch.equal(sign_mantissa, want_s)
    back = plane_ops.merge_bf16_plain(exponent, sign_mantissa)
    assert back.dtype == torch.bfloat16
    assert torch.equal(_bits(back), _bits(x))


def test_split_puts_each_field_in_its_byte():
    x = _words([0b1_10000101_0110011, 0b0_00000000_0000001])
    exponent, sign_mantissa = plane_ops.split_bf16_plain(x)
    assert exponent.tolist() == [0b10000101, 0]
    assert sign_mantissa.tolist() == [0b1_0110011, 0b0_0000001]


@pytest.mark.parametrize("case", ["odd", "special"])
def test_wrappers_take_the_plain_versions_on_the_cpu(case):
    x = _case(case)
    before = (k_planes.launches.n, k_planes.merge_launches.n,
              plane_ops.cuda_calls.n)
    exponent, sign_mantissa = k_planes.split_bf16(x)
    want = plane_ops.split_bf16_plain(x)
    assert torch.equal(exponent, want[0])
    assert torch.equal(sign_mantissa, want[1])
    assert torch.equal(_bits(k_planes.merge_bf16(exponent, sign_mantissa)),
                       _bits(x))
    assert (k_planes.launches.n, k_planes.merge_launches.n,
            plane_ops.cuda_calls.n) == before


# the roundtrip through the card path's entry points

@pytest.mark.parametrize("case", CASES)
def test_roundtrip_is_bit_exact(kernel_path, case):
    x = _case(case)
    enc, buf, back, out = _roundtrip(x)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert torch.equal(_bits(out), _bits(x))
    assert enc.n == back.n == x.numel()
    assert torch.equal(back.sign_mantissa, enc.sign_mantissa)
    assert buf.dtype == torch.uint8


@pytest.mark.parametrize("offset", [1, 3, 7, 8])
def test_view_off_a_16_byte_address_is_read_in_place(kernel_path, offset):
    base = _case("odd")
    assert base.data_ptr() % 16 == 0
    x = base[offset: offset + 3001]
    assert x.data_ptr() % 16 == 2 * offset % 16
    enc, buf, _, out = _roundtrip(x)
    assert torch.equal(_bits(out), _bits(x))
    assert torch.equal(buf, container.dumps_device(api.encode(
        x.clone(), device="cpu")))


def test_bf16_of_any_shape_is_flattened(kernel_path):
    x = _case("odd")[:4096].reshape(64, 64)
    enc = api.encode(x, device="cpu")
    assert enc.n == 4096
    out = api.decode(enc, device="cpu")
    assert torch.equal(_bits(out), _bits(x.reshape(-1)))


def test_given_codebook_codes_the_exponent_plane(kernel_path):
    x = _case("odd")
    exponent, _ = plane_ops.split_bf16_plain(x)
    book = api.build_codebook(exponent, device="cpu")
    enc = api.encode(x, device="cpu", codebook=book)
    assert np.array_equal(enc.exponent.codebook.lengths, book.lengths)
    lacking = Codebook.from_frequencies(
        np.bincount(exponent.numpy()[:100], minlength=256))
    with pytest.raises(ValueError, match="absent from the codebook"):
        api.encode(x, device="cpu", codebook=lacking)


def test_uint8_tensors_still_take_the_dense_path(kernel_path):
    x = _case("odd").view(torch.uint8)
    enc = api.encode(x, device="cpu")
    assert isinstance(enc, api.ResidentEncoded)
    assert container.dumps_device(enc)[4] == container.VERSION


# the container version 4

def _config() -> dict:
    config = harness.Cell(CELL).config
    return config | {"reference_policy": dict(
        config["reference_policy"], sample_min_bytes=SAMPLE_MIN)}


@pytest.mark.parametrize("case", NONEMPTY)
def test_v4_container_is_the_references(kernel_path, case):
    x = _case(case)
    _, buf, _, _ = _roundtrip(x)
    blob = buf.numpy().tobytes()
    sections, size, work = ref_df11.expect(x.view(torch.uint8),
                                           _config())
    mismatches = check.container_mismatches(blob, sections, size)
    assert sum(mismatches.values()) == 0, mismatches
    assert work["format"] == "df11" and work["elements"] == x.numel()
    assert container.container_version(blob) == container.PLANES_VERSION


@pytest.mark.parametrize("case", NONEMPTY)
def test_exponent_part_is_the_v1_container_of_the_exponent_plane(
        kernel_path, case):
    x = _case(case)
    v4 = container.dumps_device(api.encode(x, device="cpu"))
    exponent, sign_mantissa = plane_ops.split_bf16_plain(x)
    v1 = container.dumps_device(api.encode(exponent, device="cpu"))
    # the headers differ in the version alone; the CRC fields differ
    assert v4[4] == 4 and v1[4] == 1
    assert torch.equal(v4[:4], v1[:4]) and torch.equal(v4[5:HEAD],
                                                       v1[5:HEAD])
    stream_end = v1.numel() - 4
    assert torch.equal(v4[HEAD:stream_end], v1[HEAD:stream_end])
    assert torch.equal(v4[stream_end: stream_end + x.numel()],
                       sign_mantissa)
    assert v4.numel() == stream_end + x.numel() + 4


@pytest.mark.parametrize("case", ["odd", "special"])
def test_container_without_a_checksum(kernel_path, case):
    x = _case(case)
    enc = api.encode(x, device="cpu")
    with_crc = container.dumps_device(enc)
    buf = container.dumps_device(enc, checksum=False)
    assert buf.numel() == with_crc.numel() - 4
    assert buf[8] == 0 and with_crc[8] == container.FLAG_CRC32
    back = container.loads_device(buf)
    assert torch.equal(_bits(api.decode(back, device="cpu")), _bits(x))


def test_empty_tensor_roundtrips(kernel_path):
    enc, buf, back, out = _roundtrip(_case("empty"))
    assert enc.n == 0 and enc.exponent.block_bits.tolist() == [0]
    assert buf.numel() == container.overhead_bytes(1) + 4
    assert out.numel() == 0 and out.dtype == torch.bfloat16


def test_loaded_plane_is_a_view_of_the_buffer(kernel_path):
    _, buf, back, _ = _roundtrip(_case("odd"))
    sm = back.sign_mantissa
    assert sm.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
    assert buf.data_ptr() < sm.data_ptr() < buf.data_ptr() + buf.numel()


def test_plane_at_an_unaligned_address_is_written_the_same(kernel_path):
    x = _case("odd")
    enc = api.encode(x, device="cpu")
    shifted = torch.empty(enc.n + 1, dtype=torch.uint8)
    shifted[1:] = enc.sign_mantissa
    moved = api.PlanesEncoded(enc.exponent, shifted[1:], enc.n)
    assert torch.equal(container.dumps_device(moved),
                       container.dumps_device(enc))


def _flip(buf: torch.Tensor, at: int) -> torch.Tensor:
    buf = buf.clone()
    buf[at] ^= 1
    return buf


@pytest.mark.parametrize("case", ["odd", "special"])
@pytest.mark.parametrize("fault", [
    "plane_first_byte", "plane_last_byte", "stream_bit", "crc_bit",
    "bad_version", "version_2", "truncated_plane", "truncated_stream",
    "missing_crc", "truncated_head"])
def test_loads_device_refuses(kernel_path, case, fault):
    x = _case(case)
    enc = api.encode(x, device="cpu")
    buf = container.dumps_device(enc)
    pay = container.overhead_bytes(enc.exponent.block_bits.numel())
    plane = buf.numel() - 4 - enc.n
    bad = {"plane_first_byte": lambda: _flip(buf, plane),
           "plane_last_byte": lambda: _flip(buf, buf.numel() - 5),
           "stream_bit": lambda: _flip(buf, pay + 3),
           "crc_bit": lambda: _flip(buf, buf.numel() - 1),
           "bad_version": lambda: _flip(buf, 6),
           "version_2": lambda: _flip(buf, 4).index_fill_(
               0, torch.tensor([4]), 2),
           "truncated_plane": lambda: buf[: plane + enc.n // 2],
           "truncated_stream": lambda: buf[: pay + 8],
           "missing_crc": lambda: buf[:-2],
           "truncated_head": lambda: buf[:100]}[fault]()
    with pytest.raises(ValueError):
        container.loads_device(bad)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_loads_device_reads_a_buffer_at_any_offset(kernel_path, offset):
    x = _case("odd")
    buf = container.dumps_device(api.encode(x, device="cpu"))
    shifted = torch.zeros(buf.numel() + offset, dtype=torch.uint8)
    shifted[offset:] = buf
    out = api.decode(container.loads_device(shifted[offset:]), device="cpu")
    assert torch.equal(_bits(out), _bits(x))


# the CRC pass without the swap

@pytest.mark.parametrize("n_words", [0, 1, 5, 1023, 1024, 1025, 20_001])
@pytest.mark.parametrize("mode", ["copy", "read", "copy_after"])
def test_copy_crc32_is_zlibs(n_words, mode):
    rng = np.random.default_rng(n_words)
    words = rng.integers(0, 2**32, n_words, dtype=np.uint64).astype(np.uint32)
    src = torch.from_numpy(words.view(np.int32).copy())
    dst = torch.zeros(n_words, dtype=torch.int32) if mode != "read" else None
    crc = torch.empty(1, dtype=torch.int32)
    head = b"\x01\x02\x03\x04 a stream before the plane"
    start = (torch.from_numpy(np.array([zlib.crc32(head)], np.uint32)
                              .view(np.int32)) if mode == "copy_after"
             else None)
    before = k_crc.copy_launches.n
    assert k_crc.copy_crc32(src, dst, crc, start) is crc
    assert k_crc.copy_launches.n == before
    want = zlib.crc32(words.tobytes(),
                      zlib.crc32(head) if start is not None else 0)
    assert int(crc.numpy().view(np.uint32)[0]) == want
    if dst is not None:
        assert torch.equal(dst, src)


def test_copy_crc32_refuses_one_word_for_crc_and_start():
    word = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        k_crc.copy_crc32(torch.zeros(4, dtype=torch.int32), None,
                         word[:1], word[:1])


# what crosses and the spans

def test_only_counts_tables_and_heads_cross(kernel_path):
    x = _case("sampled")
    before = {k: c.n for k, c in timing.copied.items()}
    enc, buf, back, out = _roundtrip(x)
    assert torch.equal(_bits(out), _bits(x))
    moved = sum(c.n - before[k] for k, c in timing.copied.items())
    # two histograms, a K1 pass's counts, two heads, two CRC checks'
    # words, two tables of codes: far under 1% of the 600 KB
    assert moved < 2 * x.numel() // 100 + (16 << 10)


def _tree(recs) -> dict:
    out = {}
    for r in recs:
        pname = None if r.parent is None else recs[r.parent].name
        p, c = out.get(r.name, (pname, 0))
        assert p == pname, (r.name, p, pname)
        out[r.name] = (pname, c + 1)
    return out


def _trees(recs) -> dict:
    by_call = {}
    for r in recs:
        by_call.setdefault(r.call, []).append(r)
    trees = {}
    for call in by_call.values():
        idx = {id(r): i for i, r in enumerate(call)}
        local = [copy.copy(r) for r in call]
        for r, orig in zip(local, call):
            r.parent = (None if orig.parent is None
                        else idx[id(recs[orig.parent])])
        trees[local[0].name] = _tree(local)
    return trees


@pytest.mark.parametrize("case", ["sampled", "odd"])
def test_planes_path_records_its_spans(kernel_path, case):
    x = _case(case)
    with profile(activities=[ProfilerActivity.CPU]):
        enc, tr = api.encode_traced(x, device="cpu")
        buf = container.dumps_device(enc)
        api.decode(container.loads_device(buf), device="cpu")
    recs = timing.spans()
    roots = {r.name: r for r in recs if r.parent is None}
    assert set(roots) == {"encode", "container.dumps", "container.loads",
                          "decode"}
    for name in ("encode", "decode"):
        assert roots[name].attrs["resident"] is True
        assert roots[name].attrs["planes"] is True
    for name in ("container.dumps", "container.loads"):
        assert roots[name].attrs["device"] is True
    for root in roots.values():
        assert root.attrs["bytes"] == 2 * x.numel()
    split = next(r for r in recs if r.name == "encode.split")
    assert split.attrs == {"elements": x.numel(), "plane_bytes": x.numel()}
    trees = _trees(recs)
    assert trees["encode"]["encode.split"] == ("encode", 1)
    assert trees["encode"]["encode.pack"] == ("encode", 1)
    assert trees["encode"]["encode.codebook"] == ("encode", 1)
    assert ("encode.sample" in trees["encode"]) == (case == "sampled")
    assert trees["decode"] == {
        "decode": (None, 1), "decode.offsets": ("decode", 1),
        "decode.upload": ("decode", 1), "decode.kernel": ("decode", 1),
        "decode.merge": ("decode", 1)}
    for root in ("container.dumps", "container.loads"):
        assert trees[root] == {
            root: (None, 1), "container.head": (root, 1),
            "container.crc": (root, 1), "container.plane": (root, 1)}
    # the split opens the encode, the merge closes the decode
    order = [r.name for r in recs]
    assert order.index("encode.split") == order.index("encode") + 1
    assert order[-1] == "decode.merge"


# the generator and the readers of the cell's new metrics

def test_generator_draws_the_cells_tensors():
    traffic = harness.Cell(CELL).traffic
    assert traffic["bytes"] == 2 * sum(math.prod(t["shape"])
                                       for t in traffic["tensors"])
    small = traffic | {"bytes": 2 * 40_000}
    g = gen.generator(traffic["profile"])
    up, down = g.counts(small)
    assert up == down == 20_000
    x = gen.generate(small, SEED, "cpu")
    assert x.dtype == torch.uint8 and x.numel() == 80_000
    assert torch.equal(x, gen.generate(small, SEED, "cpu"))
    assert not torch.equal(x, gen.generate(small, SEED + 1, "cpu"))
    w = x.view(torch.bfloat16).float()
    assert w[:up].std().item() == pytest.approx(0.02, rel=0.05)
    assert w[up:].std().item() == pytest.approx(0.02 / math.sqrt(98),
                                                rel=0.05)
    # the bf16 rounding of the same float32 draw
    rng = torch.Generator().manual_seed(SEED)
    want = (torch.randn(up, generator=rng) * 0.02).to(torch.bfloat16)
    assert torch.equal(_bits(x.view(torch.bfloat16)[:up]), _bits(want))


@pytest.mark.parametrize("n", [1, 4097, 100_001])
def test_reference_splits_in_blocks(n, monkeypatch):
    monkeypatch.setattr(ref_df11, "CHUNK", 1000)
    x = torch.from_numpy(_gaussian(n)).clone().view(torch.bfloat16)
    e, s = ref_df11.split(x.view(torch.uint8))
    want = plane_ops.split_bf16_plain(x)
    assert torch.equal(e, want[0]) and torch.equal(s, want[1])


def _reader_run(work, ops=None, spans=()):
    trace = SimpleNamespace(devices=[0], window=(9.0, 20.0),
                            ops={0: list(ops or [])})
    return SimpleNamespace(trace=trace, records=[], work=work, setup_s=0.0)


def test_planes_roofline_gives_the_hand_worked_value():
    ops = [("(anonymous namespace)::split_bf16_kernel", "kernel", 10.0,
            10.001),
           ("void (anonymous namespace)::merge_bf16_kernel(unsigned char "
            "const*)", "kernel", 10.5, 10.502),
           ("swap_crc32_kernel", "kernel", 10.2, 10.3)]
    read = harness.reader("planes_roofline")
    work = {"format": "df11", "elements": 1000}
    assert read(_reader_run(work, ops)) == pytest.approx(
        100 * 2 * 4 * 1000 / 3.35e12 / 0.003)
    assert read(_reader_run(work, ops[2:])) is None
    assert read(_reader_run({"format": "dense", "n": 1000}, ops)) is None
    assert read(SimpleNamespace(trace=None, records=[], work=work)) is None


def _span(name, parent, call, a, b, attrs):
    s = timing.Span(name, parent, call, round(a * 1e9), attrs)
    s.end_ns = round(b * 1e9)
    return s


def test_container_ms_plane_gives_the_hand_worked_value(monkeypatch):
    gib = 2**30
    recs = [
        _span("container.dumps", None, 0, 10.0, 10.01,
              {"bytes": gib, "device": True}),
        _span("container.plane", 0, 0, 10.004, 10.006, {}),
        _span("container.loads", None, 1, 10.02, 10.03,
              {"bytes": gib, "device": True}),
        _span("container.plane", 2, 1, 10.021, 10.022, {}),
        _span("container.loads", None, 2, 30.0, 30.1, {"bytes": gib}),
        _span("container.plane", 4, 2, 30.0, 30.1, {}),
    ]
    monkeypatch.setattr(timing, "spans", lambda: list(recs))
    read = harness.reader("container_ms.plane")
    assert read(_reader_run({})) == pytest.approx(2.0 + 1.0)
    monkeypatch.setattr(timing, "spans", lambda: list(recs[:2]))
    assert read(_reader_run({})) == pytest.approx(2.0)
    monkeypatch.setattr(timing, "spans", lambda: [])
    assert read(_reader_run({})) is None


def test_cell_is_in_the_benchmark_with_its_readers():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[CELL]["chips"] == 1
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in ("planes_roofline", "container_ms.plane"):
        assert per_layer[name]["workloads"] == [CELL]
    for name in ("hist_roofline", "k1_roofline", "pack_roofline",
                 "k4_roofline", "crc_roofline"):
        assert CELL not in per_layer[name]["workloads"]
    assert CELL in per_layer["host_bytes_share.device"]["workloads"]


# the cell through the harness, cut to a size the CPU holds

SMALL = (256 << 10) + 6


@pytest.fixture
def small_cell(kernel_path):
    cell = harness.Cell(CELL)
    cell.traffic = dict(cell.traffic, bytes=SMALL)
    cell.config = _config()
    return cell


class _Planted:
    """The cell's binding with one fault planted in what it returns: a
    plane byte of the container flipped (its CRC written anew, as a faulty
    writer would leave it, so that the reader takes it), or a decoded
    byte changed."""

    def __init__(self, cell, fault: str):
        self.inner = cell.system("cpu")
        self.devices, self.fault = self.inner.devices, fault

    def encode(self, x):
        return self.inner.encode(x)

    def dumps(self, enc):
        buf = self.inner.dumps(enc)
        if self.fault == "plane_byte":
            pay = container.overhead_bytes(enc.exponent.block_bits.numel())
            buf[-4 - enc.n + 77] ^= 0x10
            crc = zlib.crc32(buf[pay:-4].numpy().tobytes())
            buf[-4:] = torch.from_numpy(np.array([crc], "<u4").view(np.uint8))
        return buf

    def loads(self, buf):
        return self.inner.loads(buf)

    def decode(self, enc):
        out = self.inner.decode(enc)
        if self.fault == "decoded_byte":
            out = out.clone()
            out[12345] ^= 1
        return out


def test_cell_runs_correct(small_cell):
    r = harness.run_cell(small_cell, SEED, 0.0, False, "cpu")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == set(small_cell.metric_names(False))
    assert r["checks"]["encoded_mismatches"]["value"] == 0
    assert r["checks"]["decoded_mismatches"]["value"] == 0
    assert 4.0 < r["metrics"]["stored_bits_per_byte"]["value"] < 8.0


def test_traced_cell_reads_its_metrics(small_cell):
    r = harness.run_cell(small_cell, SEED, 0.0, True, "cpu")
    assert r["correct"], r["checks"]
    got = set(r["metrics"])
    assert {"container_ms.plane", "host_bytes_share.device",
            "idle_share.encode", "idle_share.decode",
            "idle_share.encode_call", "idle_share.decode_call",
            "copy_share.encode", "copy_share.decode", "container_ms.dumps",
            "container_ms.loads", "container_ms.dumps.crc",
            "container_ms.loads.crc", "driver.k1_passes",
            "driver_ms.sample", "driver_ms.codebook"} == got
    # no CUDA kernel runs on the CPU, so the kernels' share reads nothing
    assert "planes_roofline" not in got


def test_program_without_the_planes_fails_at_once(small_cell, monkeypatch):
    monkeypatch.delattr(api, "PlanesEncoded")
    with pytest.raises(RuntimeError, match="PlanesEncoded"):
        harness.run_cell(small_cell, SEED, 0.0, False, "cpu")


@pytest.mark.parametrize("fault", ["plane_byte", "decoded_byte"])
def test_planted_fault_is_not_correct(small_cell, fault):
    r = harness.run_cell(small_cell, SEED, 0.0, False, "cpu",
                         system=_Planted(small_cell, fault))
    assert not r["correct"], r["checks"]
    checks = {k: c["value"] for k, c in r["checks"].items()}
    if fault == "plane_byte":
        assert checks == {"encoded_mismatches": 1, "decoded_mismatches": 1}
    else:
        assert checks == {"encoded_mismatches": 0, "decoded_mismatches": 1}


def test_transfer_counts_are_the_card_paths(kernel_path, monkeypatch):
    """The bf16 path's downloads are the card path's (the (2, 256)
    histograms, 24 bytes a pass, the head) and two CRC checks' words."""
    shapes, to_host = [], transfer.to_host

    def recorded(src, *a, **k):
        shapes.append(tuple(src.shape))
        return to_host(src, *a, **k)

    monkeypatch.setattr(transfer, "to_host", recorded)
    monkeypatch.setattr(container, "to_host", recorded)
    x = _case("sampled")
    container.loads_device(container.dumps_device(api.encode(x,
                                                             device="cpu")))
    assert shapes.count((2, 256)) == 1
    assert (HEAD,) in shapes
    assert all(math.prod(s) <= 2 * 256 for s in shapes)
