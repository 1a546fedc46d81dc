"""The port's spans and copy counters (huffman_tpu_torch.utils.timing) on
the CPU.

Outside a torch.profiler session nothing is recorded and span() is one
shared null context.  Under a session every path records its span tree:
the dense driver (sampled, a forced miss and its rebuild, a staged pass
over several chunks), the wide codec, both containers, the range reads and
ShardedCodec over a CPU mesh of four; each call's root carries the bytes
it copied between host and device, which equal the arithmetic of its
shapes.  The host container keeps its span tree when it works a payload
in pieces on its worker threads, which open no span, and its roots carry
the payload bytes worked in pieces or whole.  Spans sit on the profiler's
clock and never enter its event stream.  api._kernel_path is patched
true, as in test_torch_encode_driver.py.
"""

import dataclasses
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from huffman_tpu_torch import api, container, transfer, wide
from huffman_tpu_torch.config import CodecConfig, cdiv
from huffman_tpu_torch.golden.wide_codec import ROUNDS, TILE_BYTES
from huffman_tpu_torch.ops.decode import table_entries
from huffman_tpu_torch.parallel.mesh import make_mesh
from huffman_tpu_torch.parallel.pipeline import ShardedCodec
from huffman_tpu_torch.utils import timing

SAMPLE_MIN, EVERY, CHUNK = 8 * 1024, 4, 8
CFG = CodecConfig()
BOOK = 2 * 256 * 4              # codebook_tensors: int32 codes and lengths
HIST = 256 * 8                  # one int64 histogram
SHARDS = 4


@pytest.fixture
def kernel_path(monkeypatch):
    """The kernel path on the CPU: sampling every 4th block from 8 KiB on,
    staging 8 blocks a chunk; no span left from another test."""
    monkeypatch.setattr(api, "_kernel_path", lambda device: True)
    monkeypatch.setattr(api, "SAMPLE_MIN_BYTES", SAMPLE_MIN)
    monkeypatch.setattr(api, "SAMPLE_EVERY", EVERY)
    monkeypatch.setattr(api, "CHUNK_BLOCKS", CHUNK)
    timing.clear()
    yield
    timing.clear()


def _miss_input() -> np.ndarray:
    """25 blocks whose block 1, outside the sample, holds a byte the
    sample lacks: the sampled book misses and is rebuilt."""
    rng = np.random.default_rng(9)
    data = (rng.geometric(0.4, size=24 * 1024 + 11) % 32).astype(np.uint8)
    data[1024: 1024 + 64] = 201
    return data


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def _tree(recs) -> dict:
    """{name: (parent's name, count)} of one call's spans, each inside its
    parent's time; a name that opens under more than one parent maps to
    its (parent's name, count) pairs, in order of the parents' names."""
    seen = {}
    for r in recs:
        parent = None if r.parent is None else recs[r.parent]
        if parent is not None:
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
        pname = None if parent is None else parent.name
        counts = seen.setdefault(r.name, {})
        counts[pname] = counts.get(pname, 0) + 1
    return {name: (next(iter(counts.items())) if len(counts) == 1
                   else tuple(sorted(counts.items())))
            for name, counts in seen.items()}


def _by_direction(copied: dict) -> tuple[int, int]:
    return (copied["h2d.pageable"] + copied["h2d.pinned"],
            copied["d2h.pageable"] + copied["d2h.pinned"])


def _span_words(block_bits, b0: int, b1: int) -> int:
    ends = np.cumsum(np.asarray(block_bits, np.int64))
    return cdiv(int(ends[b1 - 1]), 32) - (int(ends[b0] - block_bits[b0]) >> 5)


def _dense(data):
    return api.encode(data, device="cpu")


def _wide(data):
    return wide.encode_wide(data, device="cpu")


def _codec():
    return ShardedCodec(make_mesh(devices=["cpu"] * SHARDS))


# Each case: (setup(data) -> state, made outside the profiler;
#             call(state) -> result, the one profiled call;
#             expect(data, state, result, tree) -> (tree, (h2d, d2h)))

def _expect_dense_encode(data, _, res, tree):
    enc, tr = res
    assert tr.sampled and tr.rebuilt and tr.chunks >= 2
    nb, n, passes = CFG.num_blocks(data.size), data.size, \
        len(tr.capacities_tried)
    sample = api.sample_rows(data, CFG, EVERY).size
    return ({"encode": (None, 1), "encode.sample": ("encode", 1),
             "encode.codebook": ("encode", 1), "encode.upload": ("encode", 1),
             "encode.pass": ("encode", passes),
             "encode.stage": ("encode.pass", tr.chunks),
             "encode.bits": ("encode.pass", passes),
             "encode.rebuild": ("encode", 1), "encode.pack": ("encode", 1),
             "encode.stream": ("encode", 1),
             "encode.build": (("encode.codebook", 1), ("encode.rebuild", 1))},
            (sample + 2 * BOOK + n,
             2 * HIST + 24 * passes + 4 * nb + 4 * enc.stream_words.size))


def _dense_table(enc) -> int:
    return table_entries(enc.codebook, max(enc.codebook.max_len, 1)).nbytes


def _expect_dense_decode(data, enc, _, tree):
    nb = len(enc.block_bits)
    return ({"decode": (None, 1), "decode.offsets": ("decode", 1),
             "decode.upload": ("decode", 1), "decode.kernel": ("decode", 1),
             "decode.output": ("decode", 1)},
            (4 * nb + _dense_table(enc) + 4 * enc.stream_words.size,
             data.size))


RANGE = (1500, 9000)


def _expect_dense_range(data, enc, _, tree):
    b0, b1 = RANGE[0] // CFG.block_bytes, cdiv(RANGE[1], CFG.block_bytes)
    k = b1 - b0
    return ({"decode": (None, 1), "decode.offsets": ("decode", 1),
             "decode.upload": ("decode", 1), "decode.kernel": ("decode", 1),
             "decode.output": ("decode", 1)},
            (12 * k + _dense_table(enc)
             + 4 * _span_words(enc.block_bits, b0, b1),
             RANGE[1] - RANGE[0]))


def _expect_wide_encode(data, _, enc, tree):
    nt = wide.num_tiles(data.size)
    return ({"encode": (None, 1), "encode.upload": ("encode", 1),
             "encode.codebook": ("encode", 1),
             "encode.build": ("encode.codebook", 1),
             "encode.pass": ("encode", 1),
             "encode.schedule": ("encode", 1), "encode.emit": ("encode", 1),
             "encode.stream": ("encode", 1)},
            (data.size + BOOK + 4 * nt,
             HIST + 1 + 8 + 4 * enc.payload_words.size + 4 * nt
             + 4 * ROUNDS * nt))


def _wide_h2d(enc, t0: int, t1: int) -> int:
    k = t1 - t0
    ends = np.cumsum(2 * np.asarray(enc.tile_words, np.int64))
    words = int(ends[t1 - 1] - (ends[t0 - 1] if t0 else 0))
    mcl = wide.reader_mcl(enc.codebook)
    return (8 + 4 + 4 * ROUNDS + 4) * k + 4 * words + 2 * 2 ** mcl


def _expect_wide_decode(data, enc, _, tree):
    return ({"decode": (None, 1), "decode.offsets": ("decode", 1),
             "decode.upload": ("decode", 1), "decode.kernel": ("decode", 1),
             "decode.output": ("decode", 1)},
            (_wide_h2d(enc, 0, len(enc.tile_words)), data.size))


def _expect_wide_range(data, enc, _, tree):
    t0, t1 = RANGE[0] // TILE_BYTES, cdiv(RANGE[1], TILE_BYTES)
    return ({"decode": (None, 1), "decode.offsets": ("decode", 1),
             "decode.upload": ("decode", 1), "decode.kernel": ("decode", 1),
             "decode.output": ("decode", 1)},
            (_wide_h2d(enc, t0, t1), RANGE[1] - RANGE[0]))


def _expect_container(root, children):
    def expect(data, state, res, tree):
        return ({root: (None, 1), **{c: (root, 1) for c in children}},
                (0, 0))
    return expect


def _expect_sharded_encode(data, _, enc, tree):
    passes = tree["encode.pass"][1]
    nb = CFG.num_blocks(data.size)
    padded = cdiv(nb, SHARDS) * SHARDS
    bits = np.zeros(padded, np.int64)
    bits[:nb] = enc.block_bits
    totals = bits.reshape(SHARDS, -1).sum(axis=1)
    base = np.cumsum(totals) - totals
    used = ((base & 31) + totals + 31) >> 5
    return ({"encode": (None, 1), "encode.upload": ("encode", 1),
             "encode.codebook": ("encode", 1),
             "encode.build": ("encode.codebook", 1),
             "encode.pass": ("encode", passes),
             "encode.bases": ("encode", 1), "encode.pack": ("encode", 1),
             "encode.stream": ("encode", 1),
             "encode.assemble": ("encode", 1)},
            (data.size + BOOK * passes,
             8 * SHARDS + HIST * SHARDS + 4 * padded * passes
             + 4 * int(used.sum())))


def _expect_sharded_decode(data, enc, _, tree):
    nb = len(enc.block_bits)
    k = cdiv(nb, SHARDS)
    spans = [(s * k, min(nb, (s + 1) * k)) for s in range(SHARDS)]
    h2d = sum(12 * (b1 - b0) + _dense_table(enc)
              + 4 * _span_words(enc.block_bits, b0, b1) for b0, b1 in spans)
    return ({"decode": (None, 1), "decode.shard": ("decode", SHARDS),
             "decode.offsets": ("decode.shard", SHARDS),
             "decode.upload": ("decode.shard", SHARDS),
             "decode.kernel": ("decode.shard", SHARDS),
             "decode.output": ("decode", 1)},
            (h2d, nb * CFG.block_bytes))


def _expect_sharded_encode_wide(data, _, enc, tree):
    # one tile a shard, three of them empty
    return ({"encode": (None, 1), "encode.upload": ("encode", 1),
             "encode.codebook": ("encode", 1),
             "encode.build": ("encode.codebook", 1),
             "encode.shard": ("encode", SHARDS),
             "encode.pass": ("encode.shard", SHARDS),
             "encode.schedule": ("encode.shard", SHARDS),
             "encode.emit": ("encode.shard", SHARDS),
             "encode.stream": ("encode", 1)},
            (data.size + SHARDS * (BOOK + 4),
             SHARDS * (8 + HIST) + SHARDS * (1 + 8)
             + 4 * enc.payload_words.size + SHARDS * 4 * (1 + ROUNDS)))


def _expect_sharded_decode_wide(data, enc, _, tree):
    # one tile: the first shard decodes it, the other three are idle
    return ({"decode": (None, 1), "decode.shard": ("decode", SHARDS),
             "decode.offsets": ("decode.shard", 1),
             "decode.upload": ("decode.shard", 1),
             "decode.kernel": ("decode.shard", 1),
             "decode.output": ("decode", 1)},
            (_wide_h2d(enc, 0, 1), TILE_BYTES))


DUMPS = ("container.words", "container.crc", "container.join")
LOADS = ("container.crc", "container.words")

CASES = {
    "dense_encode": (lambda d: None,
                     lambda s, d: api.encode_traced(d, device="cpu"),
                     _expect_dense_encode),
    "dense_decode": (_dense, lambda s, d: api.decode(s, device="cpu"),
                     _expect_dense_decode),
    "dense_range": (_dense,
                    lambda s, d: api.decode_range(s, *RANGE, device="cpu"),
                    _expect_dense_range),
    "wide_encode": (lambda d: None,
                    lambda s, d: wide.encode_wide(d, device="cpu"),
                    _expect_wide_encode),
    "wide_decode": (_wide, lambda s, d: wide.decode_wide(s, device="cpu"),
                    _expect_wide_decode),
    "wide_range": (_wide,
                   lambda s, d: wide.decode_wide_range(s, *RANGE,
                                                       device="cpu"),
                   _expect_wide_range),
    "dumps": (_dense, lambda s, d: container.dumps(s),
              _expect_container("container.dumps", DUMPS)),
    "loads": (lambda d: container.dumps(_dense(d)),
              lambda s, d: container.loads(s),
              _expect_container("container.loads", LOADS)),
    "dumps_wide": (_wide, lambda s, d: container.dumps_wide(s),
                   _expect_container("container.dumps", DUMPS)),
    "loads_wide": (lambda d: container.dumps_wide(_wide(d)),
                   lambda s, d: container.loads_wide(s),
                   _expect_container("container.loads", LOADS)),
    "sharded_encode": (lambda d: None, lambda s, d: _codec().encode(d),
                       _expect_sharded_encode),
    "sharded_decode": (lambda d: _codec().encode(d),
                       lambda s, d: _codec().decode(s),
                       _expect_sharded_decode),
    "sharded_encode_wide": (lambda d: None,
                            lambda s, d: _codec().encode_wide(d),
                            _expect_sharded_encode_wide),
    "sharded_decode_wide": (lambda d: _codec().encode_wide(d),
                            lambda s, d: _codec().decode_wide(s),
                            _expect_sharded_decode_wide),
}


@pytest.mark.parametrize("case", CASES)
def test_path_records_its_span_tree_and_copies(case, kernel_path):
    setup, call, expect = CASES[case]
    data = _miss_input()
    state = setup(data)
    timing.clear()
    res = _profiled(lambda: call(state, data))
    recs = timing.spans()
    tree = _tree(recs)
    want_tree, want_bytes = expect(data, state, res, tree)
    assert tree == want_tree
    (root,) = [r for r in recs if r.parent is None]
    assert {r.call for r in recs} == {root.call}
    assert root.attrs["bytes"] in (data.size, RANGE[1] - RANGE[0])
    assert _by_direction(root.attrs["copied"]) == want_bytes
    assert all(r.attrs == {} or r is root or set(r.attrs) <= {
        "cap", "shard", "device", "caps", "books"} for r in recs)
    # each host build finishes one codebook, its caps priced first
    assert all(r.attrs["books"] == 1 and r.attrs["caps"][0]
               == CFG.max_code_len for r in recs if r.name == "encode.build")


def _payload_state(case: str, nbytes: int):
    """The state that CONTAINER_CASES[case] serializes, or the container
    it loads, with a payload of nbytes of random words."""
    words = np.random.default_rng(3).integers(0, 2**32, nbytes // 4,
                                              dtype=np.uint32)
    data = _miss_input()
    if "wide" in case:
        enc = dataclasses.replace(_wide(data), payload_words=words)
        return (enc if case == "dumps_wide"
                else container.dumps_wide(enc))
    enc = dataclasses.replace(_dense(data), stream_words=words,
                              total_bits=32 * words.size)
    return enc if case == "dumps" else container.dumps(enc)


# case: (call, root, children, payload passes: swap or copy, and CRC)
CONTAINER_CASES = {
    "dumps": (container.dumps, "container.dumps", DUMPS, 2),
    "loads": (container.loads, "container.loads", LOADS, 2),
    "dumps_wide": (container.dumps_wide, "container.dumps", DUMPS, 1),
    "loads_wide": (container.loads_wide, "container.loads", LOADS, 1),
}


@pytest.mark.parametrize("size", ["pieces", "whole"])
@pytest.mark.parametrize("case", CONTAINER_CASES)
def test_container_counts_its_pieces_in_the_same_span_tree(
        case, size, kernel_path, monkeypatch):
    """A payload of PINNED_MIN_BYTES is worked in pieces on the workers,
    one 4 bytes smaller in one piece: the root carries container_bytes
    accordingly (the v3 words are read in place, so only their CRC
    counts), the span tree is DUMPS' or LOADS', and every span is opened
    on the calling thread."""
    call, root, children, passes = CONTAINER_CASES[case]
    nbytes = transfer.PINNED_MIN_BYTES - 4 * (size == "whole")
    monkeypatch.setattr(container, "WORKERS", 4)
    state = _payload_state(case, nbytes)
    threads = set()

    class Recording(timing._Recording):
        def __init__(self, name, attrs):
            threads.add(threading.get_ident())
            super().__init__(name, attrs)

    monkeypatch.setattr(timing, "_Recording", Recording)
    timing.clear()
    _profiled(lambda: call(state))
    recs = timing.spans()
    assert _tree(recs) == {root: (None, 1), **{c: (root, 1)
                                               for c in children}}
    assert threads == {threading.get_ident()}
    assert recs[0].parent is None and {r.call for r in recs} == {
        recs[0].call}
    other = "whole" if size == "pieces" else "pieces"
    assert recs[0].attrs["container_bytes"] == {size: passes * nbytes,
                                                other: 0}


def test_nothing_is_recorded_without_a_profiler(kernel_path):
    before = {k: c.n for k, c in timing.copied.items()}
    data = _miss_input()
    enc = container.loads(container.dumps(_dense(data)))
    np.testing.assert_array_equal(api.decode(enc, device="cpu"), data)
    assert timing.spans() == []
    assert timing.span("a") is timing.span("b", x=1)
    with timing.span("a") as inside:
        assert inside is None
    # the copy counters count whether or not spans are recorded
    assert timing.copied["h2d.pageable"].n > before["h2d.pageable"]
    assert timing.copied["d2h.pageable"].n > before["d2h.pageable"]


def test_recorder_nests_by_thread_and_closes_on_error(kernel_path):
    def other_thread():
        with timing.span("other"):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("a", bytes=3):
            timing.copied["h2d.pinned"].n += 5
            timing.host_blocks["reused"].n += 7
            timing.container_bytes["pieces"].n += 11
            with timing.span("a.b", cap=1):
                timing.copied["d2h.pageable"].n += 2
                t = threading.Thread(target=other_thread)
                t.start()
                t.join()
        with pytest.raises(ValueError):
            with timing.span("c"):
                raise ValueError
        with timing.span("d"):
            pass
    recs = timing.spans()
    assert [r.name for r in recs] == ["a", "a.b", "other", "c", "d"]
    assert [r.parent for r in recs] == [None, 0, None, None, None]
    assert len({r.call for r in recs}) == 4 and recs[0].call == recs[1].call
    assert recs[0].attrs == {"bytes": 3, "copied": {
        "h2d.pageable": 0, "h2d.pinned": 5, "d2h.pageable": 2,
        "d2h.pinned": 0}, "host_blocks": {"reused": 7, "new": 0,
                                          "declined": 0},
        "container_bytes": {"pieces": 11, "whole": 0}}
    assert recs[1].attrs == {"cap": 1}
    assert all(r.end_ns >= r.start_ns for r in recs)
    timing.clear()
    assert timing.spans() == []


def test_spans_are_on_the_profilers_clock(kernel_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):    # a first range costs ~1 ms
            pass
        for i in range(5):
            with record_function(f"clock.{i}"):
                with timing.span(f"clock.{i}"):
                    time.sleep(0.002)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("clock.")}
    recs = timing.spans()
    assert len(recs) == len(events) == 5
    for r in recs:
        e = events[r.name]
        assert abs(r.start_ns - e.start_ns()) < 1_000_000
        assert abs(r.end_ns - e.start_ns() - e.duration_ns()) < 1_000_000


def test_spans_stay_out_of_the_profilers_events(kernel_path):
    data = _miss_input()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        enc = container.loads(container.dumps(_dense(data)))
        api.decode(enc, device="cpu")
    names = {r.name for r in timing.spans()}
    assert {"encode", "encode.pass", "container.crc", "decode.kernel"} <= names
    assert not names & {e.name() for e in prof.profiler.kineto_results.events()}
    package = Path(api.__file__).resolve().parent
    assert not [p for p in package.rglob("*.py")
                if "record_function" in p.read_text()]
