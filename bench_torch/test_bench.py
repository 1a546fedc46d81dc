"""CPU checks of the benchmark at sizes a test run holds:

  * the plain references equal the program's containers and the format
    specification, and decode what they encode;
  * each kernel metric's byte count is the bytes the inputs need;
  * a run of every cell, driven through the harness with the chip's check
    skipped, comes out correct; with the control in the program's place,
    or a fault planted in the program, it comes out not correct.

    python3 -m pytest bench_torch/test_bench.py -q

The program's kernel wrappers run their plain versions on CPU tensors,
and the dense driver's sampled path is taken on the CPU as its own tests
take it (api._kernel_path patched), from 64 KiB up.
"""

from __future__ import annotations

import copy
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_torch import control, gen, harness
from bench_torch.reference import codebook as ref_codebook
from bench_torch.reference import dense as ref_dense
from bench_torch.reference import wide as ref_wide

SIZES = {"dense.pavle-1g": 256 << 10, "wide.pavle-1g": (512 << 10) + 1000,
         "sharded4.pavle-1g": 256 << 10}
SAMPLE_MIN = 64 << 10
SEED = 3_000_000_019
FAULTS = {"dense": ["altered_word", "altered_byte", "half_dropped",
                    "unchanged"],
          "wide": ["altered_word", "altered_byte", "half_dropped",
                   "unchanged"],
          "sharded": ["altered_word", "altered_byte", "half_dropped",
                      "unchanged", "no_exchange"]}


@pytest.fixture
def small(monkeypatch):
    """Cells cut to SIZES, the dense driver's sample taken from SAMPLE_MIN
    bytes on in the program and the reference alike."""
    from huffman_tpu_torch import api
    monkeypatch.setattr(api, "_kernel_path", lambda device: True)
    monkeypatch.setattr(api, "SAMPLE_MIN_BYTES", SAMPLE_MIN)

    def make(name: str):
        cell = harness.Cell(name)
        cell.traffic = dict(cell.traffic, bytes=SIZES[name])
        if ref_dense.sample_every(cell.config) > 1:
            policy = cell.config["reference_policy"]
            cell.config = dict(cell.config, reference_policy=dict(
                policy, sample_min_bytes=SAMPLE_MIN))
        return cell
    return make


BYTES_256 = {"profile": "geometric", "symbols": 256,
             "entropy_bits_per_byte": 7.0}


def _input(name: str, n: int) -> torch.Tensor:
    traffic = (BYTES_256 if name == "256-symbols"
               else harness.Cell(name).traffic)
    return gen.generate(traffic | {"bytes": n}, SEED, "cpu")


@pytest.mark.parametrize("name", sorted(SIZES))
def test_sound_run_is_correct(small, name):
    r = harness.run_cell(small(name), SEED, 0.0, False, "cpu")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == set(small(name).metric_names(False))
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", sorted(SIZES))
def test_control_is_not_correct(small, name):
    r = control.run_mode(small(name), "control", SEED, 0.0, "cpu")
    assert not r["correct"]
    assert r["checks"]["encoded_mismatches"]["value"] > 0
    assert r["checks"]["decoded_mismatches"]["value"] == 0


@pytest.mark.parametrize("name,mode", [
    (name, mode) for name in sorted(SIZES)
    for mode in FAULTS[harness.Cell(name).config["system"]]])
def test_fault_is_not_correct(small, name, mode):
    r = control.run_mode(small(name), mode, SEED, 0.0, "cpu")
    assert not r["correct"], (mode, r["checks"])


def test_traced_run_reads_per_layer_metrics(small):
    cell = small("wide.pavle-1g")
    r = harness.run_cell(cell, SEED, 0.0, True, "cpu")
    assert r["correct"]
    assert {"container_ms.dumps", "container_ms.loads"} <= set(r["metrics"])
    assert "busy_s" in r["device"] and "breakdown" in r


@pytest.mark.parametrize("n", [1, 1023, 3 * 1024 + 5, 70_000])
def test_dense_reference_decodes_what_it_encodes(n):
    x = _input("dense.pavle-1g", n)
    lengths = ref_codebook.code_lengths(ref_dense.byte_counts(x), 12, 0.01)
    block_bits, words = ref_dense.encode(x, lengths, 1024)
    out = ref_dense.decode(n, lengths, block_bits, words, 1024)
    assert torch.equal(out, x)


@pytest.mark.parametrize("n", [5, 262_144, 262_144 + 300_001])
def test_wide_reference_equals_the_specification(n):
    from huffman_tpu_torch.golden import wide_codec
    x = _input("256-symbols", n)
    lengths = ref_codebook.code_lengths(ref_dense.byte_counts(x), 12, 0.01)
    tile_words, bases, payload, _ = ref_wide.encode(x, lengths)
    tiles, _ = wide_codec.encode(x.numpy(), ref_codebook.canonical_codes(
        lengths).astype(np.uint32), lengths)
    want = np.concatenate([np.concatenate([p0, p1]) for p0, p1, _ in tiles])
    assert np.array_equal(payload.numpy(), want)
    assert np.array_equal(tile_words.numpy(), [t[0].size for t in tiles])
    assert np.array_equal(bases.numpy(), np.stack([t[2] for t in tiles]))
    out = ref_wide.decode(n, lengths, tile_words, payload)
    assert torch.equal(out, x)


def test_reference_codebook_equals_the_programs():
    from huffman_tpu_torch.codebook import Codebook
    rng = np.random.default_rng(7)
    for symbols in (1, 2, 5, 32, 200, 256):
        for _ in range(4):
            freqs = np.zeros(256, np.int64)
            freqs[:symbols] = rng.geometric(rng.uniform(0.01, 0.9), symbols)
            for cap, tol in ((12, 0.01), (11, 0.01), (12, 0.0), (16, 0.05)):
                want = Codebook.from_frequencies_auto(freqs, cap, tol)
                got = ref_codebook.code_lengths(freqs, cap, tol)
                assert np.array_equal(got, want.lengths)
                assert np.array_equal(ref_codebook.canonical_codes(got),
                                      want.codes)


def _metric(name: str):
    path = Path(harness.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kernel_byte_counts_are_what_the_inputs_need():
    """Each roofline's bytes, at a small shape, against a tally from the
    program's plain versions on the same input: what each kernel reads
    once and writes once, its output cut to the words its bits fill."""
    from huffman_tpu_torch import api, wide
    from huffman_tpu_torch.config import CodecConfig
    from huffman_tpu_torch.ops import encode as plain_k1
    from huffman_tpu_torch.ops import wide as plain_wide

    n, bb = 37 * 1024, 1024
    x = _input("dense.pavle-1g", n)
    config = harness.Cell("dense.pavle-1g").config | {"reference_policy": {}}
    _, _, work = ref_dense.expect(x, config)
    cfg = CodecConfig()
    enc = api.encode(x.numpy(), cfg, device="cpu")
    blocks, valid = api.device_blocks(x.numpy(), cfg, torch.device("cpu"))
    codes, lengths = api.codebook_tensors(enc.codebook, torch.device("cpu"))
    _, bits = plain_k1.encode_blocks(blocks, codes, lengths, valid, 128)
    used = int(((bits.long() + 31) // 32).sum())
    nb, nw = n // bb, enc.stream_words.size
    launches = {"encode": 1, "histogram": 1, "pack2": 1, "dense_decode": 1}
    rt = {"n": n, "info": {"capacities_tried": [128], "launches": launches}}
    assert _metric("k1_roofline").bytes_of(rt, work) == \
        n + 4 * nb + 2 * 1024 + 4 * used + 4 * nb
    assert used * 4 < nb * 128 * 4                # not the capacity rows
    assert _metric("hist_roofline").bytes_of(rt, work) == n + 256 * 8
    assert _metric("pack_roofline").bytes_of(rt, work) == \
        4 * used + (4 + 8 + 4) * nb + 4 * nw
    tb = int(enc.codebook.lengths.max())
    assert _metric("k4_roofline").bytes_of(rt, work) == \
        4 * nw + (8 + 4 + 4) * nb + 2 * 2**tb + n

    n = 2 * 262_144
    x = _input("wide.pavle-1g", n)
    _, _, work = ref_wide.expect(x, harness.Cell("wide.pavle-1g").config)
    we = wide.encode_wide(x.numpy(), device="cpu")
    rows, valid = wide.device_substreams(x.numpy(), torch.device("cpu"))
    codes, lengths = api.codebook_tensors(we.codebook, torch.device("cpu"))
    mcl = wide.reader_mcl(we.codebook)
    _, sub_bits, _ = plain_wide.sub_encode(rows, codes, lengths, valid,
                                           wide.slot_words(mcl))
    ns, nt, nw = rows.shape[0], 2, we.payload_words.size
    sub_used = int(((sub_bits.long() + 31) // 32).sum())
    launches = {"wide_encode": 1, "wide_emit": 1, "wide_decode": 1,
                "histogram": 1}
    rt = {"n": n, "info": {"launches": launches}}
    assert _metric("k5_roofline").bytes_of(rt, work) == \
        n + 4 * ns + 2 * 1024 + 4 * sub_used + 4 * ns + 64 * ns
    assert sub_used < ns * wide.slot_words(mcl)      # not the slot rows
    assert _metric("emit_roofline").bytes_of(rt, work) == \
        64 * ns + 4 * nt + 256 * nt + 4 * nt + 4 * nw + 4 * nw + 8 * nt
    assert _metric("k8_roofline").bytes_of(rt, work) == \
        4 * nw + (8 + 4 + 256 + 4) * nt + 2 * 2**mcl + n


def test_bench_file_names_a_reader_for_every_metric():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(_metric(m["name"]).read), m["name"]
    for w in bench["workloads"]:
        cell = harness.Cell(w["name"], copy.deepcopy(bench))
        assert callable(gen.generator(cell.traffic["profile"]).generate)
        assert importlib.util.find_spec(
            f"bench_torch.systems.{cell.traffic['loop']}."
            f"{cell.config['system']}"), w["name"]
