#!/usr/bin/env python3
"""The encode stages and walls that the histogram sets, for several trees
in turns, on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/hist_stages.py --trees DIR1,DIR2,DIR2,DIR1 \\
        [--data DIR3] [--out FILE]

Each DIR is a checkout of this repository (a `git archive` of an older
commit under the gitignored chip_scratch/, or `.`); a tree named twice
runs twice, so `parent,change,change,parent` gives each two turns.  For
each tree in order a child process imports that tree's package and
chip_smoke.py and, on the 1 GiB main input (testdata.entropy_stream, seed
0, as chip_smoke.py's main phase; --data keeps it between runs, as the
ablation scripts do):
  - times api.encode, wide.encode_wide and ShardedCodec.encode (four
    shards of cuda:0), two calls each, host wall with the device
    synchronized;
  - runs that tree's chip_smoke dense_breakdown, wide_breakdown and
    sharded_breakdown, whose sample_histogram_codebook,
    rebuild_histogram_codebook and histogram_codebook stages hold the
    histogram with the host codebook build.
The records print as JSON lines; --out writes them all.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN_BYTES = 1 << 30
WALL_CALLS = 2


def child(tree: str, data_dir: str) -> dict:
    """The walls and stage breakdowns of one tree (imported from `tree`)."""
    sys.path.insert(0, tree)
    import torch
    import chip_smoke
    from huffman_tpu_torch import api, wide
    from huffman_tpu_torch.parallel.mesh import make_mesh
    from huffman_tpu_torch.parallel.pipeline import ShardedCodec
    for mod in (chip_smoke, api):
        if not os.path.abspath(mod.__file__).startswith(tree):
            raise RuntimeError(f"imported {mod.__file__}, not {tree}'s")
    card = chip_smoke.nvidia_smi()
    data = np.load(os.path.join(data_dir, "1GiB.npy"))
    api.encode(data[: 64 << 20], device="cuda")        # builds the kernels
    codec = ShardedCodec(make_mesh(devices=["cuda:0"] * 4))
    walls = {"encode": [], "encode_wide": [], "sharded_encode": []}
    for _ in range(WALL_CALLS):
        (enc, trace), s = chip_smoke.wall(
            lambda: api.encode_traced(data, device="cuda"))
        walls["encode"].append(s)
        walls["encode_wide"].append(chip_smoke.wall(
            lambda: wide.encode_wide(data, device="cuda"))[1])
        sharded, s = chip_smoke.wall(lambda: codec.encode(data))
        walls["sharded_encode"].append(s)
    rec = {"tree": tree, "card": card, "trace": {
               "sampled": trace.sampled, "rebuilt": trace.rebuilt},
           "wall_s": walls,
           "dense_breakdown_ms": chip_smoke.dense_breakdown(
               data, enc, trace, card)["ms"],
           "wide_breakdown_ms": chip_smoke.wide_breakdown(data, card)["ms"],
           "sharded_breakdown_ms": chip_smoke.sharded_breakdown(
               codec, data, sharded, card)["ms"]}
    torch.cuda.synchronize()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", default=".")
    ap.add_argument("--data", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", nargs=2, metavar=("TREE", "DATA"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print("STAGES" + json.dumps(child(*args.child)), flush=True)
        return 0
    import tempfile
    import torch
    if not torch.cuda.is_available():
        print("hist_stages: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from huffman_tpu_torch.utils import testdata
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = args.data or tmp
        os.makedirs(data_dir, exist_ok=True)
        path = os.path.join(data_dir, "1GiB.npy")
        if not os.path.exists(path):
            np.save(path, testdata.entropy_stream(MAIN_BYTES, seed=0))
        for tree in args.trees.split(","):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--child", os.path.abspath(tree), data_dir],
                               capture_output=True, text=True, timeout=600)
            lines = [ln for ln in r.stdout.splitlines()
                     if ln.startswith("STAGES")]
            if r.returncode or not lines:
                raise RuntimeError(f"tree {tree} failed:\n"
                                   f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
            rec = json.loads(lines[-1][len("STAGES"):])
            rec["seconds"] = time.perf_counter() - t0
            records.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
