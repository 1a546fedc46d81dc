"""The port's CLI (--mesh, bench, info, devices), codebook models and
utils on CPU, against huffman_tpu.

The sharded CLI paths bit-exact against the golden encoder; the models'
code lengths and streams, and the stats and printers strings, equal to the
JAX package's on the same inputs; time_fn's record; the device probes.
Tolerance zero throughout.
"""

import json
import os

import numpy as np
import pytest
import torch

from huffman_tpu import api as ref_api
from huffman_tpu import golden as ref_golden
from huffman_tpu import models as ref_models
from huffman_tpu.codebook import Codebook as RefCodebook
from huffman_tpu.config import CodecConfig as RefConfig
from huffman_tpu.golden.numpy_codec import packed_bytes_to_words
from huffman_tpu.utils import printers as ref_printers
from huffman_tpu.utils import stats as ref_stats

from huffman_tpu_torch import api, cli, container, models
from huffman_tpu_torch.codebook import Codebook
from huffman_tpu_torch.config import CodecConfig
from huffman_tpu_torch.utils import device as device_utils
from huffman_tpu_torch.utils import printers, stats, testdata
from huffman_tpu_torch.utils.timing import HostTimer, time_fn


@pytest.fixture()
def src(tmp_path):
    data = testdata.skewed(50_000, num_symbols=24, seed=3)
    path = tmp_path / "in.bin"
    path.write_bytes(data.tobytes())
    return data, str(path)


@pytest.mark.parametrize("mesh", ["2", "auto"])
def test_cli_mesh_encode_decode_bit_exact(src, tmp_path, capsys, mesh):
    data, path = src
    htz, out = str(tmp_path / "in.htz"), str(tmp_path / "out.bin")
    assert cli.main(["encode", path, "-o", htz, "--verify", "--mesh", mesh,
                     "--device", "cpu"]) == 0
    assert "verify vs golden: PASS" in capsys.readouterr().out
    enc = container.load(htz)
    g_bytes, g_bits = ref_golden.encode(data, RefCodebook.from_lengths(
        enc.codebook.lengths))
    assert enc.total_bits == g_bits
    np.testing.assert_array_equal(enc.stream_words,
                                  packed_bytes_to_words(g_bytes))
    assert open(htz, "rb").read() == container.dumps(
        api.encode(data, device="cpu"))
    assert cli.main(["decode", htz, "-o", out, "--mesh", mesh,
                     "--device", "cpu"]) == 0
    assert open(out, "rb").read() == data.tobytes()
    # the wide format through the mesh, too
    assert cli.main(["encode", path, "-o", htz, "--format", "wide",
                     "--mesh", mesh, "--device", "cpu"]) == 0
    assert container.container_version(open(htz, "rb").read()) == 3
    assert cli.main(["decode", htz, "-o", out, "--mesh", mesh,
                     "--device", "cpu"]) == 0
    assert open(out, "rb").read() == data.tobytes()


@pytest.mark.parametrize("mesh", [None, "2"])
def test_cli_bench(src, tmp_path, capsys, mesh):
    data, path = src
    log_dir = tmp_path / "logs"
    argv = ["bench", path, "--iters", "2", "--verify", "--log-dir",
            str(log_dir), "--device", "cpu"] + (["--mesh", mesh] if mesh
                                                else [])
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "ms median (2 iters)" in out and "verify: PASS" in out
    (jsonl,) = [f for f in os.listdir(log_dir) if f.endswith(".jsonl")]
    rec = json.loads(open(log_dir / jsonl).read())
    assert rec["series"] == "encode" and rec["bytes"] == data.size
    assert rec["shards"] == (int(mesh) if mesh else 1)
    assert os.path.exists(log_dir / "graph__encode__rate_series.txt")


def test_cli_info_and_devices(src, tmp_path, capsys, monkeypatch):
    data, path = src
    htz = str(tmp_path / "in.htz")
    for fmt, head in (("dense", "v1 (dense), 50000 B original"),
                      ("wide", "v3 (wide), 50000 B original")):
        assert cli.main(["encode", path, "-o", htz, "--format", fmt,
                         "--device", "cpu"]) == 0
        capsys.readouterr()
        assert cli.main(["info", htz]) == 0
        assert f"{htz}: {head}" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["devices"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("0 cuda device(s)") and "[cpu]" in out
    assert "(process 0)" in out


def test_device_probes(monkeypatch):
    assert device_utils.probe_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(device_utils.DeviceError, match="unknown device"):
        device_utils.probe_devices("tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (device_utils.probe_devices, device_utils.device_memory_stats):
        with pytest.raises(device_utils.DeviceError, match="no cuda"):
            fn()


def test_models_equal_reference():
    sample = testdata.skewed(20_000, num_symbols=40, seed=4)
    data = testdata.skewed(30_000, num_symbols=40, seed=5)
    cfg, ref_cfg = CodecConfig(), RefConfig()
    fixed = models.FixedCodebook.train(sample, cfg)
    ref_fixed = ref_models.FixedCodebook.train(sample, ref_cfg)
    np.testing.assert_array_equal(fixed.codebook.lengths,
                                  ref_fixed.codebook.lengths)
    assert (fixed.codebook.lengths > 0).all()        # add-one smoothing
    assert not fixed.needs_histogram
    huff = models.CanonicalHuffman(cfg, device="cpu")
    ref_huff = ref_models.CanonicalHuffman(ref_cfg)
    assert huff.needs_histogram
    np.testing.assert_array_equal(huff.codebook_for(data).lengths,
                                  ref_huff.codebook_for(data).lengths)
    for model, ref_model in ((fixed, ref_fixed), (huff, ref_huff)):
        enc = api.encode(data, cfg, model=model, device="cpu")
        ref = ref_api.encode(data, ref_cfg, model=ref_model)
        np.testing.assert_array_equal(enc.stream_words, ref.stream_words)
        assert enc.total_bits == ref.total_bits
        np.testing.assert_array_equal(api.decode(enc, device="cpu"), data)


def test_model_codebook_counts_as_explicit():
    sample = testdata.skewed(20_000, num_symbols=8, seed=4)
    data = sample.copy()
    data[100] = 250
    model = models.FixedCodebook(Codebook.from_data(sample))
    with pytest.raises(ValueError, match="absent from the codebook"):
        api.encode(data, model=model, device="cpu")
    # an explicit codebook wins over the model
    cb = Codebook.from_data(data)
    enc = api.encode(data, codebook=cb, model=model, device="cpu")
    np.testing.assert_array_equal(enc.codebook.lengths, cb.lengths)


def test_codebook_validate():
    lens = np.zeros(256, np.int32)
    lens[:3] = [1, 1, 2]                          # Kraft sum 1.25
    with pytest.raises(ValueError, match="Kraft sum 1.25 > 1"):
        models.FixedCodebook(Codebook.from_lengths(lens))
    with pytest.raises(ValueError, match="Kraft sum 1.25 > 1"):
        RefCodebook.from_lengths(lens).validate()
    Codebook.from_lengths(np.full(256, 8)).validate()


def test_stats_files_equal_reference(tmp_path):
    assert stats.gb_per_s(512.0, 250.0) == ref_stats.gb_per_s(512.0, 250.0)
    assert stats.gb_per_s(1.0, 0.0) == ref_stats.gb_per_s(1.0, 0.0) == 0.0
    dirs = []
    for mod, name in ((stats, "port"), (ref_stats, "ref")):
        d = tmp_path / name
        log = mod.StatsLogger(str(d), run_name="run")
        rec = log.log_rate("encode", 64.0, 12.5, file="x", ts=1.0)
        log.log({"note": "done", "ts": 2.0})
        log.add_series_point("extra", "a", "b", 1.5, 2.25)
        assert rec["gbps"] == mod.gb_per_s(64.0, 12.5)
        dirs.append(d)
    names = sorted(os.listdir(dirs[0]))
    assert names == sorted(os.listdir(dirs[1])) and len(names) == 4
    for f in names:
        assert (dirs[0] / f).read_bytes() == (dirs[1] / f).read_bytes()


def test_printers_equal_reference():
    data = testdata.skewed(4096, num_symbols=40, seed=6)
    cb = Codebook.from_data(data)
    ref_cb = RefCodebook.from_data(data)
    enc = api.encode(data, codebook=cb, device="cpu")
    words = enc.stream_words
    other = words.copy()
    other[[3, 17]] ^= 0x80000001
    for fn, args, ref_args in (
            (printers.bits32, (0xDEADBEEF,), (0xDEADBEEF,)),
            (printers.format_codebook, (cb,), (ref_cb,)),
            (printers.format_codebook, (cb, False), (ref_cb, False)),
            (printers.format_bitstream, (words, enc.total_bits),
             (words, enc.total_bits)),
            (printers.format_bitstream, (words, 40, 512), (words, 40, 512)),
            (printers.diff_words, (words, other), (words, other)),
            (printers.diff_words, (words, words[:-1]), (words, words[:-1]))):
        assert fn(*args) == getattr(ref_printers, fn.__name__)(*ref_args)


def test_timing_helpers():
    calls = []
    st = time_fn(lambda: calls.append(1), iters=3, warmup=1, device="cpu")
    assert set(st) == {"mean_ms", "min_ms", "median_ms", "iters"}
    assert st["iters"] == 3 and len(calls) == 4
    assert 0 <= st["min_ms"] <= st["median_ms"]
    with HostTimer() as t:
        torch.ones(8).sum()
    assert t.ms >= 0
