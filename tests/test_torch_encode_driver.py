"""The port's encode driver (the kernel path of api.encode) on CPU, against
huffman_tpu's.

The kernel path (sampled codebook with its miss rebuild, the capacity
schedule with its safe retry, chunked staging) runs on a CUDA device; here
api._kernel_path is patched true and the kernel wrappers run their plain
versions, as the JAX package's tests force its Mosaic branch with
interpret-mode kernels (test_spec_cap.mosaic_on_cpu).  _cap_schedule,
_kernel_mcl and the sampled build_codebook against the JAX package's; four
inputs of test_spec_cap.py and test_sampled.py through both drivers, with
the capacities tried, stream words, block bits and code lengths equal;
chunked staging against one copy and the golden encoder; the ValueError of
a given codebook; and the sharded encode's schedule.  Exact equality.
"""

import numpy as np
import pytest

from huffman_tpu import api as ref_api
from huffman_tpu.config import CodecConfig as RefConfig

from huffman_tpu_torch import api, golden, transfer
from huffman_tpu_torch.codebook import Codebook
from huffman_tpu_torch.config import CodecConfig
from huffman_tpu_torch.golden.numpy_codec import packed_bytes_to_words
from huffman_tpu_torch.ops.cuda import encode as k_encode
from huffman_tpu_torch.parallel.mesh import make_mesh
from huffman_tpu_torch.parallel.pipeline import ShardedCodec

from test_spec_cap import mosaic_on_cpu as _mosaic_impl

SAMPLE_MIN, EVERY, CHUNK = 8 * 1024, 4, 8


@pytest.fixture
def reference_kernel_path(monkeypatch):
    """The JAX package's Mosaic branch in interpret mode, sampling every
    4th block from 8 KiB on; returns its record of kernel calls.  The
    encode calls of its speculative tree's patch pass (_patch_flagged,
    Mosaic-only: K1 has no merge tree) go to "patch", so that "encode"
    holds one capacity per pass over the blocks."""
    monkeypatch.setattr(ref_api, "SAMPLE_MIN_BYTES", SAMPLE_MIN)
    monkeypatch.setattr(ref_api, "SAMPLE_EVERY", EVERY)
    calls = _mosaic_impl.__wrapped__(monkeypatch)
    calls["patch"] = []
    real_patch = ref_api._patch_flagged

    def patch(*a, **k):
        i = len(calls["encode"])
        out = real_patch(*a, **k)
        calls["patch"] += calls["encode"][i:]
        del calls["encode"][i:]
        return out

    monkeypatch.setattr(ref_api, "_patch_flagged", patch)
    return calls


@pytest.fixture
def kernel_path(monkeypatch):
    """The port's kernel path on the CPU, sampling as the reference's
    fixture does and staging 8 blocks a chunk."""
    monkeypatch.setattr(api, "_kernel_path", lambda device: True)
    monkeypatch.setattr(api, "SAMPLE_MIN_BYTES", SAMPLE_MIN)
    monkeypatch.setattr(api, "SAMPLE_EVERY", EVERY)
    monkeypatch.setattr(api, "CHUNK_BLOCKS", CHUNK)


def _check_golden(data, enc):
    ref_bytes, ref_bits = golden.encode(data, enc.codebook)
    assert enc.total_bits == ref_bits
    np.testing.assert_array_equal(enc.stream_words,
                                  packed_bytes_to_words(ref_bytes))


# test_spec_cap.py:20-36, each case (config, kmcl, est_bpb, schedule)
SPEC_CAP_CASES = [
    (CodecConfig(), 8, 2.1, [128, 256]),
    (CodecConfig(), 8, 3.5, [256]),
    (CodecConfig(), 8, None, [256]),
    (CodecConfig(), 4, 3.9, [128]),
    (CodecConfig(), 16, None, [256]),
    (CodecConfig(capacity_bits_per_byte=16), 16, None, [512]),
    (CodecConfig(spec_bits_per_byte=0), 8, 2.1, [256]),
]


def _ref_cfg(cfg: CodecConfig) -> RefConfig:
    return RefConfig(capacity_bits_per_byte=cfg.capacity_bits_per_byte,
                     spec_bits_per_byte=cfg.spec_bits_per_byte)


@pytest.mark.parametrize("cfg,kmcl,est,want", SPEC_CAP_CASES)
def test_cap_schedule_reference_cases(cfg, kmcl, est, want):
    assert api._cap_schedule(cfg, kmcl, est) == want
    assert ref_api._cap_schedule(_ref_cfg(cfg), kmcl, est) == want


GRID_CONFIGS = [CodecConfig(),
                CodecConfig(capacity_bits_per_byte=16, spec_bits_per_byte=8),
                CodecConfig(capacity_bits_per_byte=12, spec_bits_per_byte=0)]


@pytest.mark.parametrize("c", range(len(GRID_CONFIGS)))
@pytest.mark.parametrize("est", (None, 2.1, 3.25, 3.5, 3.9))
@pytest.mark.parametrize("kmcl", (4, 8, 12, 16))
def test_cap_schedule_grid_equals_reference(kmcl, est, c):
    cfg = GRID_CONFIGS[c]
    assert api._cap_schedule(cfg, kmcl, est) == ref_api._cap_schedule(
        _ref_cfg(cfg), kmcl, est)


@pytest.mark.parametrize("max_len", (1, 3, 4, 5, 8, 9, 12, 13, 16))
def test_kernel_mcl_equals_reference(max_len):
    from huffman_tpu.codebook import Codebook as RefCodebook
    lens = np.zeros(256, np.int32)
    lens[: max_len + 1] = list(range(1, max_len + 1)) + [max_len]
    assert api._kernel_mcl(Codebook.from_lengths(lens)) == \
        ref_api._kernel_mcl(RefCodebook.from_lengths(lens))


def test_kernel_mcl_24():
    lens = np.zeros(256, np.int32)
    lens[:25] = list(range(1, 25)) + [24]
    assert api._kernel_mcl(Codebook.from_lengths(lens)) == 24
    assert api._cap_schedule(CodecConfig(max_code_len=24,
                                         capacity_bits_per_byte=24),
                             24, None) == [768]


@pytest.mark.parametrize("n", (32 * 1024 + 321, 33 * 1024 + 5, 3 * 1024,
                               700))
def test_sampled_build_codebook_equals_reference(n):
    data = (np.random.default_rng(n).geometric(0.4, size=n) % 32).astype(
        np.uint8)
    cfg = CodecConfig()
    cb = api.build_codebook(data, cfg, "cpu", sample_every=4)
    ref = ref_api.build_codebook(data, RefConfig(), use_device=False,
                                 sample_every=4)
    np.testing.assert_array_equal(cb.lengths, ref.lengths)
    np.testing.assert_array_equal(cb.codes, ref.codes)
    assert cb.est_bpb == ref.est_bpb
    valid = transfer.valid_on(n, cfg.num_blocks(n), cfg.block_bytes, "cpu")
    assert api.sample_rows(data, cfg, 4).size == int(valid[::4].sum())


def _spec_holds():
    rng = np.random.default_rng(0)
    return (rng.geometric(0.5, size=4 * 1024 + 37) % 32).astype(np.uint8)


def _spec_retry():
    rng = np.random.default_rng(0)
    head = (rng.geometric(0.5, size=7 * 1024) % 8).astype(np.uint8)
    hot = (200 + np.arange(1024, dtype=np.uint8) % 16).astype(np.uint8)
    return np.concatenate([head, hot])


def _sampled_holds():
    rng = np.random.default_rng(0)
    return (rng.geometric(0.4, size=48 * 1024 + 37) % 32).astype(np.uint8)


def _sampled_miss():
    rng = np.random.default_rng(9)
    data = (rng.geometric(0.4, size=48 * 1024 + 11) % 32).astype(np.uint8)
    data[1 * 1024: 1 * 1024 + 64] = 201      # blocks 1 and 2: unsampled
    data[2 * 1024: 2 * 1024 + 64] = 202
    return data


DRIVER_CASES = {"spec_holds": _spec_holds, "spec_retry": _spec_retry,
                "sampled_holds": _sampled_holds,
                "sampled_miss": _sampled_miss}


@pytest.mark.parametrize("case", DRIVER_CASES)
def test_driver_equals_reference(case, reference_kernel_path, kernel_path):
    data = DRIVER_CASES[case]()
    ref = ref_api.encode(data, RefConfig())
    enc, trace = api.encode_traced(data, CodecConfig(), device="cpu")
    assert trace.capacities_tried == reference_kernel_path["encode"]
    assert reference_kernel_path["pack"] == [trace.capacities_tried[-1]]
    np.testing.assert_array_equal(enc.codebook.lengths, ref.codebook.lengths)
    np.testing.assert_array_equal(enc.block_bits, ref.block_bits)
    np.testing.assert_array_equal(enc.stream_words, ref.stream_words)
    assert enc.total_bits == ref.total_bits
    _check_golden(data, enc)
    nb = CodecConfig().num_blocks(data.size)
    assert trace.sampled == (data.size >= SAMPLE_MIN)
    assert trace.chunks == (-(-nb // CHUNK) if trace.sampled and nb > CHUNK
                            else 0)
    # the passes: one per capacity tried, one more round after a rebuild
    assert len(trace.capacities_tried) >= 1 + trace.rebuilt
    if case == "sampled_miss":
        assert trace.rebuilt
        assert enc.codebook.lengths[201] and enc.codebook.lengths[202]
    if case == "spec_retry":
        assert trace.capacities_tried[-2:] == [128, 256]
    if case == "spec_holds":
        assert trace.capacities_tried == [128] and not trace.sampled


@pytest.mark.parametrize("given", (False, True))
def test_chunked_equals_one_copy_and_golden(given, kernel_path, monkeypatch):
    rng = np.random.default_rng(4)
    data = (rng.geometric(0.5, size=35 * 1024 + 123) % 32).astype(np.uint8)
    cb = (api.build_codebook(data, CodecConfig(), "cpu") if given else None)
    enc, trace = api.encode_traced(data, codebook=cb, device="cpu")
    assert trace.chunks == 5 and trace.sampled == (not given)
    monkeypatch.setattr(api, "CHUNK_BLOCKS", 1 << 30)
    one, one_trace = api.encode_traced(data, codebook=enc.codebook,
                                       device="cpu")
    assert one_trace.chunks == 0
    assert one_trace.capacities_tried == trace.capacities_tried[-1:]
    np.testing.assert_array_equal(enc.stream_words, one.stream_words)
    np.testing.assert_array_equal(enc.block_bits, one.block_bits)
    _check_golden(data, enc)
    np.testing.assert_array_equal(api.decode(enc, device="cpu"), data)


def test_given_codebook_missing_symbol_raises_chunked(kernel_path):
    rng = np.random.default_rng(5)
    data = (rng.geometric(0.5, size=30 * 1024 + 9) % 16).astype(np.uint8)
    cb = api.build_codebook(data, CodecConfig(), "cpu")
    data[20 * 1024 + 3] = 250                # in the third chunk
    with pytest.raises(ValueError, match="absent from the codebook"):
        api.encode(data, codebook=cb, device="cpu")


def test_stage_chunks_zero_fills_and_covers():
    import torch
    arr = np.arange(1000, dtype=np.uint8)
    rows = torch.full((1280,), 7, dtype=torch.uint8)
    spans = list(transfer.stage_chunks(arr, rows, 384))
    assert spans == [(0, 384), (384, 768), (768, 1152), (1152, 1280)]
    np.testing.assert_array_equal(rows[:1000].numpy(), arr)
    assert not rows[1000:].any()


def test_sharded_encode_runs_the_schedule(kernel_path, monkeypatch):
    caps = []
    real = k_encode.encode_blocks

    def record(*a, **k):
        caps.append(a[4])
        return real(*a, **k)

    monkeypatch.setattr(k_encode, "encode_blocks", record)
    data = _spec_retry()
    codec = ShardedCodec(make_mesh(devices=["cpu"] * 4))
    enc = codec.encode(data)
    assert caps == [128] * 4 + [256] * 4
    exact = api.build_codebook(data, CodecConfig(), "cpu")
    np.testing.assert_array_equal(enc.codebook.lengths, exact.lengths)
    caps.clear()
    single = api.encode(data, codebook=enc.codebook, device="cpu")
    assert caps == [128, 256]
    np.testing.assert_array_equal(enc.stream_words, single.stream_words)
    np.testing.assert_array_equal(enc.block_bits, single.block_bits)
    _check_golden(data, enc)
