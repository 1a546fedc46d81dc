"""Card-resident data on the CPU: api.encode of a uint8 tensor on the
codec's device, container.dumps_device / loads_device and api.decode into
a tensor, with the kernel path patched on (the CUDA kernels' plain
versions run on CPU tensors), as bench_torch/test_bench.py's `small`
fixture does.  A sampled encode of a tensor takes the sample's and the
exact histogram together and builds one codebook before K1, which then
never misses.

The device path's container equals the host path's byte for byte and the
plain reference's sections (bench_torch/reference/dense.py), it decodes
to its input, the plain CRC equals zlib's, loads_device refuses what
loads refuses, only the histograms, bit counts, tables and heads cross
between host and device, and the spans of the path are recorded.  The
cell device.pavle-1g runs correct at a small size through the harness,
and not correct with a fault planted in its container or its output.
"""

import copy
import functools
import importlib.util
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
from huffman_tpu_torch.config import CodecConfig
from huffman_tpu_torch.models import FixedCodebook
from huffman_tpu_torch.ops import crc32 as crc_ops
from huffman_tpu_torch.ops.cuda import crc32 as k_crc
from huffman_tpu_torch.ops.cuda import encode as k_encode
from huffman_tpu_torch.ops.decode import table_entries
from huffman_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch import check, gen, harness  # noqa: E402
from bench_torch.reference import dense as ref_dense  # noqa: E402

SIZES = [0, 1, 1023, 1024, 4097, 5 << 20]
PROFILES = ["pavle", "256-symbols"]
SEED = 3_000_000_019
CELL = "device.pavle-1g"
CPU = torch.device("cpu")
CFG = CodecConfig()
BOOK = 2 * 256 * 4              # codebook_tensors: int32 codes and lengths
HIST = 256 * 8                  # one int64 histogram
HEAD = 40 + 256                 # the v1 header and the code lengths


@pytest.fixture
def kernel_path(monkeypatch):
    monkeypatch.setattr(api, "_kernel_path", lambda device: True)
    timing.clear()
    yield
    timing.clear()


@functools.lru_cache(maxsize=None)
def _input(profile: str, n: int) -> np.ndarray:
    traffic = ({"profile": "geometric", "symbols": 256,
                "entropy_bits_per_byte": 7.0} if profile == "256-symbols"
               else harness.Cell(CELL).traffic)
    return gen.generate(traffic | {"bytes": n}, SEED + n, "cpu").numpy()


def _roundtrip(data: np.ndarray):
    """(device container, host container, decoded tensor) of data."""
    x = torch.from_numpy(data.copy())
    enc = api.encode(x, device="cpu")
    assert isinstance(enc, api.ResidentEncoded)
    assert enc.stream_words.device == CPU == enc.block_bits.device
    buf = container.dumps_device(enc)
    host = api.encode(data, device="cpu")
    assert isinstance(host, api.Encoded)
    return buf, container.dumps(host), api.decode(container.loads_device(buf),
                                                  device="cpu")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("profile", PROFILES)
def test_device_container_is_the_host_one_and_the_references(
        kernel_path, profile, n):
    data = _input(profile, n)
    buf, host, out = _roundtrip(data)
    assert buf.dtype == torch.uint8 and buf.device == CPU
    assert buf.numpy().tobytes() == host
    config = harness.Cell(CELL).config
    sections, size, _ = ref_dense.expect(torch.from_numpy(data.copy()),
                                         config)
    mismatches = check.container_mismatches(host, sections, size)
    assert sum(mismatches.values()) == 0, mismatches
    assert isinstance(out, torch.Tensor) and out.device == CPU
    assert torch.equal(out, torch.from_numpy(data))


def test_sampled_book_is_taken_on_the_device(kernel_path):
    data = _input("pavle", 5 << 20)
    x = torch.from_numpy(data.copy())
    _, tr = api.encode_traced(x, device="cpu")
    _, host_tr = api.encode_traced(data, device="cpu")
    # the same sample and decision; the card path makes only the pass that
    # counts, where host data's K1 also ran one under the sample's book
    assert tr.sampled and tr.rebuilt == host_tr.rebuilt
    assert tr.capacities_tried == host_tr.capacities_tried[-1:]
    assert torch.equal(api.sample_rows(x, CFG, api.SAMPLE_EVERY),
                       torch.from_numpy(api.sample_rows(data, CFG,
                                                        api.SAMPLE_EVERY)))
    for every in (1, 16):
        assert np.array_equal(
            api.build_codebook(x, device="cpu", sample_every=every).lengths,
            api.build_codebook(data, device="cpu",
                               sample_every=every).lengths)


@pytest.mark.parametrize("n", [0, 1, 3, 63, 64, 65, 4095, 4096, 4097,
                               100_003])
def test_plain_crc_is_zlibs(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    assert int(crc_ops.crc32_plain(torch.from_numpy(data))) == \
        zlib.crc32(data.tobytes())


@pytest.mark.parametrize("n_words", [0, 1, 5, 1023, 1024, 1025, 20_001])
def test_swap_crc32_both_ways(n_words):
    rng = np.random.default_rng(n_words)
    host = rng.integers(0, 2**32, n_words, dtype=np.uint64).astype(np.uint32)
    payload = host.astype(">u4").tobytes()
    src = torch.from_numpy(host.view(np.int32).copy())
    dst = torch.empty(n_words, dtype=torch.int32)
    crc = torch.empty(1, dtype=torch.int32)
    assert k_crc.swap_crc32(src, dst, crc, True) is crc
    assert dst.numpy().tobytes() == payload
    assert int(crc.numpy().view(np.uint32)[0]) == zlib.crc32(payload)
    back = torch.empty(n_words, dtype=torch.int32)
    k_crc.swap_crc32(dst, back, crc, False)
    assert torch.equal(back, src)
    assert int(crc.numpy().view(np.uint32)[0]) == zlib.crc32(payload)


def _container() -> torch.Tensor:
    return container.dumps_device(api.encode(torch.from_numpy(
        _input("pavle", 4097).copy()), device="cpu"))


def _flip(buf: torch.Tensor, at: int) -> torch.Tensor:
    buf = buf.clone()
    buf[at] ^= 1
    return buf


@pytest.mark.parametrize("fault", [
    "payload_bit", "crc_bit", "truncated_head", "truncated_header",
    "truncated_payload", "missing_crc", "bad_magic", "bad_version"])
def test_loads_device_refuses_what_loads_refuses(kernel_path, fault):
    buf = _container()
    nb = CFG.num_blocks(4097)
    pay = container.overhead_bytes(nb)
    bad = {"payload_bit": lambda: _flip(buf, pay + 5),
           "crc_bit": lambda: _flip(buf, buf.numel() - 1),
           "truncated_head": lambda: buf[:100],
           "truncated_header": lambda: buf[:20],
           "truncated_payload": lambda: buf[: pay + 8],
           "missing_crc": lambda: buf[:-2],
           "bad_magic": lambda: _flip(buf, 0),
           "bad_version": lambda: _flip(buf, 5)}[fault]()
    with pytest.raises(ValueError):
        container.loads(bad.numpy().tobytes())
    with pytest.raises(ValueError):
        container.loads_device(bad)


def test_loads_device_reads_a_buffer_at_any_offset(kernel_path):
    buf = _container()
    shifted = torch.zeros(buf.numel() + 3, dtype=torch.uint8)
    shifted[3:] = buf
    enc = container.loads_device(shifted[3:])
    assert torch.equal(api.decode(enc, device="cpu"),
                       torch.from_numpy(_input("pavle", 4097)))


def _miss_input() -> np.ndarray:
    """5 MiB whose block 1, outside the sample, holds a byte the sample
    lacks: the sampled book misses and is rebuilt."""
    data = _input("pavle", 5 << 20).copy()
    data[1024: 1024 + 64] = 201
    return data


def test_only_counts_tables_and_heads_cross(kernel_path, monkeypatch):
    data = _miss_input()
    x = torch.from_numpy(data)
    shapes, to_host = [], transfer.to_host

    def recorded(src, *a, **k):
        shapes.append(tuple(src.shape))
        return to_host(src, *a, **k)

    monkeypatch.setattr(transfer, "to_host", recorded)
    before = {k: c.n for k, c in timing.copied.items()}
    enc, tr = api.encode_traced(x, device="cpu")
    assert shapes.count((2, 256)) == 1 and (256,) not in shapes
    buf = container.dumps_device(enc)
    out = api.decode(container.loads_device(buf), device="cpu")
    assert torch.equal(out, x)
    moved = {k: c.n - before[k] for k, c in timing.copied.items()}
    h2d = moved["h2d.pageable"] + moved["h2d.pinned"]
    d2h = moved["d2h.pageable"] + moved["d2h.pinned"]
    passes = len(tr.capacities_tried)
    assert tr.sampled and tr.rebuilt and passes == 1
    tb = max(enc.codebook.max_len, 1)
    # one book's tables up; the sample's and the exact histogram down in
    # one (2, 256) copy, then 24 bytes a K1 pass
    assert h2d == BOOK + HEAD + table_entries(enc.codebook, tb).nbytes
    assert d2h == 2 * HIST + 3 * 8 * passes + HEAD + 8
    assert h2d + d2h < data.size // 100 + (64 << 10)


def _tree(recs) -> dict:
    out = {}
    for r in recs:
        pname = None if r.parent is None else recs[r.parent].name
        p, c = out.get(r.name, (pname, 0))
        assert p == pname, (r.name, p, pname)
        out[r.name] = (pname, c + 1)
    return out


def test_device_path_records_its_spans(kernel_path):
    data = _miss_input()
    x = torch.from_numpy(data)
    with profile(activities=[ProfilerActivity.CPU]):
        enc, tr = api.encode_traced(x, device="cpu")
        buf = container.dumps_device(enc)
        api.decode(container.loads_device(buf), device="cpu")
    recs = timing.spans()
    roots = {r.name: r for r in recs if r.parent is None}
    assert set(roots) == {"encode", "container.dumps", "container.loads",
                          "decode"}
    assert roots["encode"].attrs["resident"] is True
    assert roots["decode"].attrs["resident"] is True
    assert roots["container.dumps"].attrs["device"] is True
    assert roots["container.loads"].attrs["device"] is True
    for root in roots.values():
        assert root.attrs["bytes"] == data.size
        assert set(root.attrs["copied"]) == set(timing.COPY_KINDS)
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
    passes = len(tr.capacities_tried)
    assert passes == 1
    assert trees["encode"] == {
        "encode": (None, 1), "encode.sample": ("encode", 1),
        "encode.codebook": ("encode", 1),
        "encode.build": ("encode.codebook", 1),
        "encode.pass": ("encode", passes),
        "encode.bits": ("encode.pass", passes), "encode.pack": ("encode", 1)}
    book = next(r for r in recs if r.name == "encode.codebook")
    assert book.attrs["exact"] is True
    assert trees["container.dumps"] == {
        "container.dumps": (None, 1),
        "container.head": ("container.dumps", 1),
        "container.crc": ("container.dumps", 1)}
    assert trees["container.loads"] == {
        "container.loads": (None, 1),
        "container.head": ("container.loads", 1),
        "container.crc": ("container.loads", 1)}
    assert trees["decode"] == {
        "decode": (None, 1), "decode.offsets": ("decode", 1),
        "decode.upload": ("decode", 1), "decode.kernel": ("decode", 1)}


def test_card_encode_builds_one_book(kernel_path):
    """A sampled card encode builds its codebook once on the host, in span
    encode.build: the caps it priced from their lengths alone (pavle's
    bytes: the capped book's 12 and the narrow 8; 4 holds too few
    symbols), one codebook finished, and that codebook the exact
    histogram's."""
    data = _miss_input()
    with profile(activities=[ProfilerActivity.CPU]):
        enc, tr = api.encode_traced(torch.from_numpy(data), device="cpu")
    recs = timing.spans()
    (build,) = [r for r in recs if r.name == "encode.build"]
    assert tr.sampled and tr.rebuilt
    assert recs[build.parent].name == "encode.codebook"
    assert build.attrs == {"caps": (CFG.max_code_len, 8), "books": 1}
    want = Codebook.from_frequencies_auto(np.bincount(data, minlength=256),
                                          CFG.max_code_len, CFG.narrow_tol)
    assert np.array_equal(enc.codebook.lengths, want.lengths)
    assert enc.codebook.est_bpb == want.est_bpb


# The card path decides between the sample's codebook and the exact one
# from the two histograms before K1; host data decides by K1's flag.  Both
# end with the same codebook and container.  Each case names where a byte
# outside the sample lies, if any, or where the codebook comes from.

DECISION_N, DECISION_TAIL = 256 << 10, (255 << 10) + 37


def _sample_holds(data: np.ndarray) -> np.ndarray:
    """data with each byte it holds also in block 0, which is sampled."""
    present = np.flatnonzero(np.bincount(data, minlength=256))
    data[: present.size] = present
    return data


def _decision_input(case: str) -> np.ndarray:
    # DECISION_TAIL ends in block 255, which the sample (every 16th
    # block from 0) skips
    n = DECISION_TAIL if case in ("miss_tail", "no_zero_tail") else DECISION_N
    data = _input("pavle", n).copy()
    if case == "no_zero_tail":
        data[data == 0] = 1
    data = _sample_holds(data)
    if case in ("miss_unsampled", "given", "model"):
        data[1024: 1024 + 64] = 201
    if case == "miss_tail":
        data[-3] = 203
    assert case != "no_zero_tail" or not (data == 0).any()
    return data


DECISION_CASES = ["holds", "miss_unsampled", "miss_tail", "no_zero_tail",
                  "given", "model"]


def _one_flagged_pass(monkeypatch):
    """K1's first call flags a byte without a code in block 0."""
    real, calls = k_encode.encode_blocks, []

    def flagged(*a, **k):
        streams, bits = real(*a, **k)
        if not calls:
            bits[0] |= torch.iinfo(torch.int32).min
        calls.append(1)
        return streams, bits

    monkeypatch.setattr(k_encode, "encode_blocks", flagged)


@pytest.mark.parametrize("case", DECISION_CASES)
def test_card_path_decides_the_book_before_k1(kernel_path, monkeypatch,
                                              case):
    monkeypatch.setattr(api, "SAMPLE_MIN_BYTES", 64 << 10)
    data = _decision_input(case)
    book = {"given": {"codebook": api.build_codebook(data, device="cpu")},
            "model": {"model": FixedCodebook.train(data, CFG)}}.get(case, {})
    enc, tr = api.encode_traced(torch.from_numpy(data.copy()), device="cpu",
                                **book)
    host, host_tr = api.encode_traced(data, device="cpu", **book)
    assert container.dumps_device(enc).numpy().tobytes() == \
        container.dumps(host)
    assert (tr.sampled, tr.rebuilt) == (host_tr.sampled, host_tr.rebuilt)
    assert tr.sampled == (not book)
    assert tr.rebuilt == case.startswith("miss")
    # pavle's bytes fit the speculative capacity: one pass
    assert tr.capacities_tried == host_tr.capacities_tried[-1:] == [128]
    _one_flagged_pass(monkeypatch)
    with pytest.raises(ValueError, match="absent from the codebook"):
        api.encode(torch.from_numpy(data.copy()), device="cpu", **book)


def test_ragged_input_is_padded_on_the_device(kernel_path):
    x = torch.from_numpy(_input("pavle", 4097).copy())
    with profile(activities=[ProfilerActivity.CPU]):
        api.encode(x, device="cpu")
        api.encode(x[:4096], device="cpu")
    pads = [r for r in timing.spans() if r.name == "encode.pad"]
    assert len(pads) == 1


@pytest.mark.parametrize("offset", [0, 1, 4, 16])
def test_blocks_are_a_view_only_at_a_16_byte_address(offset):
    """K1 reads its blocks as words, its warp route in 16-byte pieces: a
    slice of a buffer that starts elsewhere is copied to fresh rows."""
    base = torch.from_numpy(_input("pavle", 4097 + 4096).copy())
    assert base.data_ptr() % 16 == 0
    x = base[offset: offset + 4096]
    assert x.numel() == 4096
    blocks = api.resident_blocks(x, CFG)
    assert blocks.data_ptr() % 16 == 0
    assert (blocks.data_ptr() == x.data_ptr()) == (offset % 16 == 0)
    assert torch.equal(blocks.reshape(-1), x)


@pytest.mark.parametrize("offset", [1, 4])
def test_slice_at_an_offset_encodes_as_the_host_copy(kernel_path, offset):
    data = _input("pavle", 4097 + 4096)
    x = torch.from_numpy(data.copy())[offset: offset + 8192]
    enc = api.encode(x, device="cpu")
    buf = container.dumps_device(enc)
    assert buf.numpy().tobytes() == container.dumps(
        api.encode(data[offset: offset + 8192], device="cpu"))
    assert torch.equal(api.decode(container.loads_device(buf),
                                  device="cpu"), x)


def test_non_byte_tensor_is_refused():
    with pytest.raises(ValueError):
        api.encode(torch.zeros(8, dtype=torch.int32), device="cpu")


def test_empty_resident_encoded_matches_the_host_one(kernel_path):
    enc = api.encode(torch.zeros(0, dtype=torch.uint8), device="cpu")
    assert enc.n_bytes == 0 and enc.block_bits.tolist() == [0]
    assert container.dumps_device(enc).numpy().tobytes() == \
        container.dumps(api.encode(np.zeros(0, np.uint8), device="cpu"))
    assert api.decode(enc, device="cpu").numel() == 0


# the cell through the harness, cut to a size the CPU holds

SMALL, SAMPLE_MIN = 256 << 10, 64 << 10


@pytest.fixture
def small_cell(monkeypatch, kernel_path):
    monkeypatch.setattr(api, "SAMPLE_MIN_BYTES", SAMPLE_MIN)
    cell = harness.Cell(CELL)
    cell.traffic = dict(cell.traffic, bytes=SMALL)
    policy = cell.config["reference_policy"]
    cell.config = dict(cell.config, reference_policy=dict(
        policy, sample_min_bytes=SAMPLE_MIN))
    return cell


class _Planted:
    """The cell's binding with one fault planted in what it returns: a
    payload word of the container flipped (its CRC written anew, as a
    faulty writer would leave it, so that the reader takes it), or a
    decoded byte changed."""

    def __init__(self, cell, fault: str):
        self.inner = cell.system("cpu")
        self.devices, self.fault = self.inner.devices, fault

    def encode(self, x):
        return self.inner.encode(x)

    def dumps(self, enc):
        buf = self.inner.dumps(enc)
        if self.fault == "payload_word":
            pay = container.overhead_bytes(enc.block_bits.numel())
            buf[pay + 4 * 7] ^= 0x10
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
    assert r["metrics"]["stored_bits_per_byte"]["value"] > 0


def test_traced_cell_reads_its_metrics(small_cell):
    r = harness.run_cell(small_cell, SEED, 0.0, True, "cpu")
    assert r["correct"], r["checks"]
    got = set(r["metrics"])
    assert {"host_bytes_share.device", "idle_share.encode",
            "idle_share.decode", "idle_share.encode_call",
            "idle_share.decode_call", "pageable_share.encode",
            "pageable_share.decode", "container_ms.dumps.crc",
            "container_ms.loads.crc", "driver.k1_passes",
            "driver_ms.sample", "driver_ms.codebook"} <= got
    # no CUDA kernel runs on the CPU, so the kernel's share reads nothing
    assert "crc_roofline" not in got


def test_program_without_the_device_path_fails_at_once(small_cell,
                                                       monkeypatch):
    monkeypatch.delattr(container, "dumps_device")
    with pytest.raises(RuntimeError, match="dumps_device"):
        harness.run_cell(small_cell, SEED, 0.0, False, "cpu")


@pytest.mark.parametrize("fault", ["payload_word", "decoded_byte"])
def test_planted_fault_is_not_correct(small_cell, fault):
    r = harness.run_cell(small_cell, SEED, 0.0, False, "cpu",
                         system=_Planted(small_cell, fault))
    assert not r["correct"], r["checks"]
    checks = {k: c["value"] for k, c in r["checks"].items()}
    if fault == "payload_word":
        assert checks["encoded_mismatches"] > 0
    else:
        assert checks == {"encoded_mismatches": 0, "decoded_mismatches": 1}


# the readers of the device path's metrics, on hand-made spans and a
# trace-shaped object (as tests/test_torch_trace_metrics.py does)

def _span(name, parent, call, a, b, attrs):
    s = timing.Span(name, parent, call, round(a * 1e9), attrs)
    s.end_ns = round(b * 1e9)
    return s


def _copied(h2d=0, d2h=0):
    return {"h2d.pageable": h2d, "h2d.pinned": 0, "d2h.pageable": d2h,
            "d2h.pinned": 0}


def _device_records():
    """A card-resident roundtrip (1 GiB) in the window, a host encode in
    the window and a card-resident encode outside it."""
    gib = 2**30
    return [
        _span("encode", None, 0, 10.0, 10.010, {
            "bytes": gib, "resident": True,
            "copied": _copied(h2d=4096, d2h=8 << 20)}),
        _span("encode.pass", 0, 0, 10.0, 10.005, {"cap": 128}),
        _span("container.dumps", None, 1, 10.010, 10.012, {
            "bytes": gib, "device": True, "copied": _copied(h2d=296)}),
        _span("container.loads", None, 2, 10.012, 10.014, {
            "bytes": gib, "device": True, "copied": _copied(d2h=304)}),
        _span("decode", None, 3, 10.014, 10.018, {
            "bytes": gib, "resident": True, "copied": _copied(h2d=8192)}),
        _span("encode", None, 4, 11.0, 12.0, {
            "bytes": gib, "copied": _copied(h2d=gib)}),
        _span("encode", None, 5, 30.0, 30.01, {
            "bytes": gib, "resident": True, "copied": _copied(h2d=gib)}),
    ]


def _device_run(monkeypatch, records):
    monkeypatch.setattr(timing, "spans", lambda: list(records))
    ops = {0: [("encode_rows_warp", "kernel", 10.000, 10.002),
               ("swap_crc32_kernel", "kernel", 10.011, 10.012),
               ("swap_crc32_kernel", "kernel", 10.012, 10.013),
               ("decode_blocks_kernel", "kernel", 10.015, 10.017),
               ("encode_rows_warp", "kernel", 11.0, 11.5)]}
    trace = SimpleNamespace(devices=[0], window=(9.0, 20.0), ops=ops)
    return SimpleNamespace(trace=trace, records=[], work={}, setup_s=0.0)


def test_device_readers_give_the_hand_worked_values(monkeypatch):
    run = _device_run(monkeypatch, _device_records())
    assert harness.reader("host_bytes_share.device")(run) == pytest.approx(
        100 * (4096 + (8 << 20) + 296 + 304 + 8192) / 2**30)


def test_device_readers_find_nothing_on_the_host_path(monkeypatch):
    host_only = [r for r in _device_records()
                 if not (r.attrs.get("resident") or r.attrs.get("device"))
                 and r.parent is None]
    run = _device_run(monkeypatch, host_only)
    assert harness.reader("host_bytes_share.device")(run) is None


def test_crc_roofline_counts_each_word_read_and_written():
    mod = importlib.util.module_from_spec(importlib.util.spec_from_file_location(
        "crc_roofline", harness.HERE / "metrics" / "crc_roofline.py"))
    mod.__spec__.loader.exec_module(mod)
    work = {"format": "dense", "stream_words": 1000}
    rt = {"info": {"launches": {"crc32": 2}}}
    assert mod.bytes_of(rt, work) == 2 * (4 + 4) * 1000
    assert mod.bytes_of({"info": {"launches": {}}}, work) == 0
    assert mod.bytes_of(rt, {"format": "wide"}) == 0
