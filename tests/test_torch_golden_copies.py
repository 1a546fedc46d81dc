"""The port's own copies of the golden oracles, against the JAX package's.

huffman_tpu_torch/golden/wide_codec.py (the wide format's specification)
and golden/cpu_codec.cpp (the C++ golden codec, built by the port into its
own build directory) are copies: they must give the same results as
huffman_tpu/golden/wide_codec.py and huffman_tpu/golden/cpu_codec.cpp on
the same seeded inputs, tolerance zero.  And the port must stand alone: a
copy of huffman_tpu_torch/ by itself, with nothing of the repository
beside it, imports every module and runs both oracles.
"""

import ast
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from huffman_tpu import golden as ref_golden
from huffman_tpu.codebook import Codebook as RefCodebook
from huffman_tpu.golden import wide_codec as ref_W

from huffman_tpu_torch import golden
from huffman_tpu_torch.codebook import Codebook
from huffman_tpu_torch.golden import wide_codec as W
from huffman_tpu_torch.utils import testdata
from test_torch_api import PORT_MODULES, ROOT

TILE = W.TILE_BYTES


def book_and_data(mcl: int, n: int, seed: int):
    """A codebook whose longest code is `mcl` bits (Kraft sum 1) and n bytes
    drawn with p = 2**-length, so every code length occurs."""
    lens = np.zeros(256, np.int32)
    lens[: mcl + 1] = list(range(1, mcl + 1)) + [mcl]
    p = 2.0 ** -lens[: mcl + 1]
    data = np.random.default_rng(seed).choice(
        mcl + 1, size=n, p=p / p.sum()).astype(np.uint8)
    return Codebook.from_lengths(lens), data


WIDE_CASES = [
    # mcl, bytes, seed: several tiles with a partial last one, and a
    # partial single tile of a narrow book (the pull rule's mcl * rem)
    pytest.param(12, 2 * TILE + 5000, 1, id="mcl12_tiles3_partial"),
    pytest.param(4, TILE - 1000, 2, id="mcl4_partial_tile"),
]


def test_wide_spec_constants_equal():
    for name in ("TILE_BYTES", "SUB_BYTES", "N_SUB", "MAXLEN", "SPR",
                 "ROUNDS", "THRESH"):
        assert getattr(W, name) == getattr(ref_W, name), name


@pytest.mark.parametrize("mcl,n,seed", WIDE_CASES)
def test_wide_tile_codec_equal(mcl, n, seed):
    cb, data = book_and_data(mcl, min(n, TILE), seed)
    assert cb.max_len == mcl
    got = W.encode_tile(data, cb.codes, cb.lengths)
    ref = ref_W.encode_tile(data, cb.codes, cb.lengths)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    syms, lens = cb.decode_table(mcl)
    back = W.decode_tile(got[0], got[1], data.size, syms, lens, mcl, mcl)
    ref_back = ref_W.decode_tile(ref[0], ref[1], data.size, syms, lens, mcl,
                                 mcl)
    assert np.array_equal(back, ref_back) and np.array_equal(back, data)


@pytest.mark.parametrize("mcl,n,seed", WIDE_CASES)
def test_wide_stream_codec_equal(mcl, n, seed):
    cb, data = book_and_data(mcl, n, seed + 10)
    tiles, size = W.encode(data, cb.codes, cb.lengths)
    ref_tiles, ref_size = ref_W.encode(data, cb.codes, cb.lengths)
    assert size == ref_size == n and len(tiles) == len(ref_tiles)
    for got, ref in zip(tiles, ref_tiles):
        for g, r in zip(got, ref):
            assert np.array_equal(g, r)
    syms, lens = cb.decode_table(mcl)
    back = W.decode(tiles, n, syms, lens, mcl, mcl)
    assert np.array_equal(back, ref_W.decode(ref_tiles, n, syms, lens, mcl,
                                             mcl))
    assert np.array_equal(back, data)


@pytest.mark.parametrize("n,nsym,seed", [
    (100_000, 32, 0),                    # the main path's profile
    (65_537, 256, 1),                    # all 256 symbols, odd length
    (1, 1, 2),                           # one byte, one-symbol codebook
])
def test_cpu_codec_equal(n, nsym, seed):
    data = testdata.skewed(n, num_symbols=nsym, seed=seed)
    cb = Codebook.from_data(data)
    ref_cb = RefCodebook.from_data(data)
    assert np.array_equal(cb.lengths, ref_cb.lengths)
    stream, bits = golden.encode(data, cb)
    ref_stream, ref_bits = ref_golden.encode(data, ref_cb)
    assert bits == ref_bits
    assert np.array_equal(stream, ref_stream)


def test_cpu_codec_24bit_codes_equal():
    lens = np.zeros(256, np.int32)
    lens[:25] = list(range(1, 25)) + [24]          # Kraft sum exactly 1
    cb = Codebook.from_lengths(lens)
    data = np.random.default_rng(3).integers(0, 25, 50_000).astype(np.uint8)
    stream, bits = golden.encode(data, cb)
    ref_stream, ref_bits = ref_golden.encode(data,
                                             RefCodebook.from_lengths(lens))
    assert bits == ref_bits == int(lens[data].sum())
    assert np.array_equal(stream, ref_stream)


def test_port_stands_alone(tmp_path):
    """A copy of huffman_tpu_torch/ alone (no build products) imports every
    module and runs golden.encode and a wide encode_tile: any load of the
    JAX package's files by path would fail here."""
    shutil.copytree(os.path.join(ROOT, "huffman_tpu_torch"),
                    tmp_path / "huffman_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    code = "\n".join([
        "import os, sys",
        *(f"import {m}" for m in PORT_MODULES),
        "import numpy as np",
        "from huffman_tpu_torch import golden",
        "from huffman_tpu_torch.codebook import Codebook",
        "from huffman_tpu_torch.golden import wide_codec as W",
        "data = (np.arange(5000) % 7).astype(np.uint8)",
        "cb = Codebook.from_data(data)",
        "stream, bits = golden.encode(data, cb)",
        "assert bits == int(cb.lengths[data].sum()) and stream.size > 0",
        "p0, p1, bases = W.encode_tile(data, cb.codes, cb.lengths)",
        "assert p0.size == p1.size > 0 and bases.shape == (W.ROUNDS,)",
        "assert golden.SOURCE.startswith(os.getcwd())",
        "bad = sorted(m for m in sys.modules",
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'huffman_tpu'))",
        "assert not bad, bad",
        "print('alone')",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "alone"
    assert (tmp_path / "huffman_tpu_torch" / "build" /
            "libhuffgolden.so").exists()


def test_scripts_read_nothing_of_the_jax_package():
    """chip_smoke.py and the scripts under scripts/ run on the card machine,
    which has no JAX: none imports jax or huffman_tpu, or names the JAX
    package's directory as a path to read."""
    files = [os.path.join(ROOT, "chip_smoke.py")] + sorted(
        os.path.join(ROOT, "scripts", f)
        for f in os.listdir(os.path.join(ROOT, "scripts"))
        if f.endswith(".py"))
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                names = []
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib",
                                                  "huffman_tpu"), (path, name)
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert not re.fullmatch(r"huffman_tpu(/.*)?", node.value), (
                    path, node.value)


# the modules above the copy layer, which the layers under them never import
UPPER = {"huffman_tpu_torch.api", "huffman_tpu_torch.wide",
         "huffman_tpu_torch.container", "huffman_tpu_torch.parallel.pipeline"}
# the names transfer.py defines, which live there alone
TRANSFER_NAMES = ("to_device", "to_host", "HostPool", "host_pool",
                  "host_block", "_host_block_path", "_pinned", "_count",
                  "_host_tensor", "PINNED_RING", "PINNED_MIN_BYTES",
                  "PINNED_POOL_BYTES", "stage_chunks", "device_rows",
                  "valid_on")


def _imports(path: str) -> list[tuple[str, set]]:
    """Each import in the port's file at `path`, relative ones resolved, as
    (name, the modules it may load): `import m` loads m; `from m import n`
    loads m and, where n is a submodule, m.n."""
    parts = os.path.relpath(path, ROOT)[:-3].split(os.sep)
    package = parts[:-1]
    out = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            out += [(a.name, {a.name}) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = package[: len(package) - node.level + 1] if node.level \
                else []
            module = ".".join(base + ([node.module] if node.module else []))
            out += [(a.name, {module, f"{module}.{a.name}"})
                    for a in node.names]
    return out


def test_layers_import_only_downwards():
    """The copy layer (transfer.py), the mesh and the ops import nothing of
    api, wide, container or parallel.pipeline; container.py takes only the
    dense result types from api (the bf16 planes' among them); and the copy
    layer's names are not found in api."""
    from huffman_tpu_torch import api
    pkg = os.path.join(ROOT, "huffman_tpu_torch")
    lower = [os.path.join(pkg, "transfer.py"),
             os.path.join(pkg, "parallel", "mesh.py")] + sorted(
        os.path.join(d, f) for d, _, fs in os.walk(os.path.join(pkg, "ops"))
        for f in fs if f.endswith(".py"))
    assert len(lower) > 10
    for path in lower:
        for name, modules in _imports(path):
            assert not modules & UPPER, (path, name)
    from_api = {name for name, modules in _imports(
        os.path.join(pkg, "container.py"))
        if "huffman_tpu_torch.api" in modules}
    assert from_api == {"Encoded", "ResidentEncoded", "PlanesEncoded"}
    assert not [n for n in TRANSFER_NAMES if hasattr(api, n)]
