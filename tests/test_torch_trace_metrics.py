"""The benchmark's readers of the program's spans and copy counters
(bench_torch/metrics/, read through the harness's reader) on a synthetic
run: hand-made span records in place of huffman_tpu_torch.utils.timing's,
and a trace-shaped object with known device operations on one card and on
four.  Each reader gives the number worked by hand, and None where it finds
no span.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from huffman_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch import harness  # noqa: E402

GIB = 2**30
WINDOW = (9.0, 20.0)


def _copied(h2d_pageable=0, h2d_pinned=0, d2h_pageable=0, d2h_pinned=0):
    return {"h2d.pageable": h2d_pageable, "h2d.pinned": h2d_pinned,
            "d2h.pageable": d2h_pageable, "d2h.pinned": d2h_pinned}


def _blocks(reused=0, new=0, declined=0):
    return {"reused": reused, "new": new, "declined": declined}


def _pieces(pieces=0, whole=0):
    return {"pieces": pieces, "whole": whole}


def _calls():
    """Six calls as (root name, (start, end) s, attrs, children), the last
    outside the window."""
    return [
        ("encode", (10.0, 11.0), {"bytes": GIB, "copied": _copied(
            h2d_pageable=100, h2d_pinned=300, d2h_pageable=100)},
         [("encode.sample", (10.0, 10.05)),
          ("encode.build", (10.05, 10.062)),
          ("encode.assemble", (10.9, 10.98))]),
        ("encode", (12.0, 12.5), {"bytes": GIB, "copied": _copied(
            d2h_pageable=500)},
         [("encode.sample", (12.0, 12.03)),
          ("encode.build", (12.03, 12.034))]),
        ("container.dumps", (11.0, 11.6), {"bytes": GIB, "copied": _copied(),
                                           "container_bytes": _pieces(600)},
         [("container.words", (11.0, 11.2)), ("container.crc", (11.2, 11.3)),
          ("container.join", (11.3, 11.55))]),
        ("container.loads", (12.5, 12.9), {"bytes": GIB // 2,
                                           "copied": _copied(),
                                           "container_bytes": _pieces(
                                               whole=200)},
         [("container.crc", (12.5, 12.6)),
          ("container.words", (12.6, 12.75))]),
        ("decode", (13.0, 14.0), {"bytes": GIB, "copied": _copied(
            h2d_pageable=50, d2h_pinned=150), "host_blocks": _blocks(
            reused=150, new=40, declined=10)},
         [("decode.output", (13.5, 14.0))]),
        ("encode", (25.0, 26.0), {"bytes": GIB, "copied": _copied(
            h2d_pageable=10**9)},
         [("encode.sample", (25.0, 25.9)),
          ("encode.build", (25.9, 25.95)),
          ("encode.assemble", (25.95, 26.0))]),
    ]


def _records():
    recs = []
    for call, (name, (a, b), attrs, children) in enumerate(_calls()):
        root = len(recs)
        recs.append(_span(name, None, call, a, b, dict(attrs)))
        for child, (c, d) in children:
            recs.append(_span(child, root, call, c, d, {}))
    return recs


def _span(name, parent, call, a, b, attrs):
    s = timing.Span(name, parent, call, round(a * 1e9), attrs)
    s.end_ns = round(b * 1e9)
    return s


# card 0 busy 0.4 s of the encode calls (two overlapping operations), 0.1
# s more in the second; 0.2 s in the container call, which is not counted;
# 0.25 s of the decode call.  With four cards, card 1 is busy through the
# first encode call and the decode call, cards 2 and 3 never.
OPS = {0: [("Memcpy HtoD (Pageable -> Device)", "memcpy", 10.2, 10.5),
           ("encode_rows_cta", "kernel", 10.4, 10.6),
           ("Memset (Device)", "memset", 12.1, 12.2),
           ("pack_tiles_kernel", "kernel", 11.2, 11.4),
           ("decode_blocks_kernel", "kernel", 13.5, 13.75)],
       1: [("encode_rows_cta", "kernel", 10.0, 11.0),
           ("decode_blocks_kernel", "kernel", 13.0, 14.0)],
       2: [], 3: []}


def _run(cards: int, trace=True):
    devices = list(range(cards))
    tr = SimpleNamespace(devices=devices, window=WINDOW,
                         ops={d: OPS[d] for d in devices})
    return SimpleNamespace(trace=tr if trace else None, records=[],
                           work={}, setup_s=0.0)


# hand-worked: the windows' encode calls are 1.5 s and hold 2 GiB
EXPECT = {
    "driver_ms.sample": (50 + 30) / 2,
    "driver_ms.codebook": (12 + 4) / 2,
    "shards_ms.assemble": 80 / 2,
    "container_ms.dumps.crc": 100.0,
    "container_ms.dumps.words": 200.0,
    "container_ms.loads.crc": 100 / 0.5,
    "container_ms.loads.words": 150 / 0.5,
    "pageable_share.encode": 100 * (100 + 100 + 500) / (100 + 300 + 100
                                                         + 500),
    "pageable_share.decode": 100 * 50 / (50 + 150),
    "pinned_reuse_share.decode": 100 * 150 / (150 + 40 + 10),
    "container_pieces_share": 100 * 600 / (600 + 200),
    "idle_share.encode_call": 100 * (1 - 0.5 / 1.5),
    "idle_share.decode_call": 100 * (1 - 0.25 / 1.0),
}
FOUR_CARDS = {
    "idle_share.encode_call": 100 * (1 - (0.5 + 1.0) / 4 / 1.5),
    "idle_share.decode_call": 100 * (1 - (0.25 + 1.0) / 4 / 1.0),
}


@pytest.fixture
def hand_made(monkeypatch):
    recs = _records()
    monkeypatch.setattr(timing, "spans", lambda: list(recs))
    return recs


def test_every_new_reader_is_in_the_benchmark():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    names = {m["name"]: m for m in bench["per_layer"]}
    assert set(EXPECT) <= set(names)
    assert names["driver_ms.sample"]["workloads"] == [
        "dense.pavle-1g", "device.pavle-1g", "df11.nemotron-h-47b-mlp"]
    assert names["shards_ms.assemble"]["workloads"] == ["sharded4.pavle-1g"]
    assert names["driver_ms.codebook"]["workloads"] == [
        "dense.pavle-1g", "wide.pavle-1g", "sharded4.pavle-1g",
        "device.pavle-1g", "df11.nemotron-h-47b-mlp"]
    assert names["container_pieces_share"]["workloads"] == [
        "dense.pavle-1g", "wide.pavle-1g", "sharded4.pavle-1g"]


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_gives_the_hand_worked_value(name, hand_made):
    assert harness.reader(name)(_run(1)) == pytest.approx(EXPECT[name])


@pytest.mark.parametrize("name", sorted(FOUR_CARDS))
def test_idle_share_averages_four_cards(name, hand_made):
    assert harness.reader(name)(_run(4)) == pytest.approx(FOUR_CARDS[name])


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_finds_nothing(name, monkeypatch):
    read = harness.reader(name)
    monkeypatch.setattr(timing, "spans", lambda: [])
    assert read(_run(1)) is None
    # only the call outside the window
    monkeypatch.setattr(timing, "spans", lambda: [
        r for r in _records() if r.call == 5])
    assert read(_run(1)) is None
    # no trace, and a program without the recorder
    monkeypatch.setattr(timing, "spans", _records)
    assert read(_run(1, trace=False)) is None
    monkeypatch.delattr(timing, "spans")
    assert read(_run(1)) is None


def test_pinned_reuse_share_without_the_pool(monkeypatch):
    """A program whose roots carry no host_blocks, as before the pool."""
    recs = _records()
    for r in recs:
        r.attrs.pop("host_blocks", None)
    monkeypatch.setattr(timing, "spans", lambda: list(recs))
    assert harness.reader("pinned_reuse_share.decode")(_run(1)) is None
    assert harness.reader("pageable_share.decode")(_run(1)) == \
        pytest.approx(EXPECT["pageable_share.decode"])


@pytest.mark.parametrize("counts,want", [
    ((_pieces(600), _pieces(200)), 100.0),
    ((_pieces(whole=600), _pieces(whole=200)), 0.0),
    ((_pieces(), _pieces()), None),             # no payload byte worked
    ((None, None), None),                       # a program without it
])
def test_container_pieces_share_all_none_and_without_the_counter(
        monkeypatch, counts, want):
    recs = _records()
    tops = [r for r in recs if r.parent is None
            and r.name.startswith("container.")]
    for r, c in zip(tops, counts):
        r.attrs.pop("container_bytes")
        if c is not None:
            r.attrs["container_bytes"] = c
    monkeypatch.setattr(timing, "spans", lambda: list(recs))
    assert harness.reader("container_pieces_share")(_run(1)) == want
