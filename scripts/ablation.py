"""The runner that the scripts/ablate_*.py scripts share.

Each of those scripts names variants of its kernels as exact text
substitutions of the sources under huffman_tpu_torch/csrc/, and a `child`
that builds a package copy and times its kernels.  This module copies a
tree's package with a variant applied, runs the child on that copy in a
process of its own, and gathers the records; it also holds the sizes and
repetitions every script times at.  It is run only through those scripts.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"64MiB": 64 << 20, "1GiB": 1 << 30}
REPS = {"64MiB": 20, "1GiB": 5}


def patch_tree(tree: str, dst: str, variant: dict) -> dict:
    """Copy tree's package to dst and apply `variant`, {kernel source:
    [alternative, ...]} where an alternative is a list of (old text, new
    text) pairs: the first alternative whose every old text is in the
    source is applied.  Returns which sources the variant applies to."""
    shutil.copytree(os.path.join(tree, "huffman_tpu_torch"),
                    os.path.join(dst, "huffman_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    applied = {}
    for src, alternatives in variant.items():
        path = os.path.join(dst, "huffman_tpu_torch", "csrc", src)
        text = open(path).read()
        applied[src] = False
        for pairs in alternatives:
            if all(old in text for old, _ in pairs):
                for old, new in pairs:
                    text = text.replace(old, new)
                open(path, "w").write(text)
                applied[src] = True
                break
    return applied


def main(script: str, doc: str, variants: dict, exact: set, child,
         extra: dict | None = None) -> int:
    """The command line of `script`: --tree DIR (a checkout, default this
    one), --variants a,b (a name given twice runs twice, in turns), --data
    DIR2 (keeps the generated inputs between runs), --out FILE, and the
    hidden --child PKG_ROOT DATA CHECK that runs child(pkg_root, data_dir,
    check) in the variant's process.  `extra` maps names that are no text
    variant to a function of the temporary directory that returns the
    record, given that directory and the inputs' directory."""
    extra = extra or {}
    name = os.path.splitext(os.path.basename(script))[0]
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--tree", default=".")
    ap.add_argument("--out", default=None)
    ap.add_argument("--variants", default=",".join([*variants, *extra]))
    ap.add_argument("--data", default=None,
                    help="directory that keeps the generated inputs "
                         "between runs (default: a temporary one)")
    ap.add_argument("--child", nargs=3, metavar=("PKG_ROOT", "DATA", "CHECK"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        root, data_dir, check = args.child
        print("ABLATE" + json.dumps(child(root, data_dir, check == "1")),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print(f"{name}: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from huffman_tpu_torch.utils import testdata
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    tree = os.path.abspath(args.tree)
    out = {"tree": tree, "card": card, "variants": {}}
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = args.data or tmp
        os.makedirs(data_dir, exist_ok=True)
        t0 = time.perf_counter()
        for size, n in SIZES.items():
            path = os.path.join(data_dir, f"{size}.npy")
            if not os.path.exists(path):
                np.save(path, testdata.entropy_stream(n, seed=0))
        out["datagen_s"] = time.perf_counter() - t0
        for i, v in enumerate(args.variants.split(",")):
            if v in extra:
                rec = extra[v](tmp, data_dir)
            else:
                vdir = os.path.join(tmp, f"{i}_{v}")
                applied = patch_tree(tree, vdir, variants[v])
                if variants[v] and not any(applied.values()):
                    out["variants"][v] = {"applies": applied}
                    continue
                r = subprocess.run([sys.executable, os.path.abspath(script),
                                    "--child", vdir, data_dir,
                                    "1" if v in exact else "0"],
                                   capture_output=True, text=True,
                                   timeout=600)
                lines = [ln for ln in r.stdout.splitlines()
                         if ln.startswith("ABLATE")]
                if r.returncode or not lines:
                    raise RuntimeError(f"variant {v} failed:\n"
                                       f"{r.stdout[-3000:]}\n"
                                       f"{r.stderr[-3000:]}")
                rec = json.loads(lines[-1][len("ABLATE"):])
                rec["applies"] = applied
            # a variant named again (runs in turns) keeps every run
            key = v if v not in out["variants"] else f"{v}#{i}"
            out["variants"][key] = rec
            print(json.dumps({key: {k: x for k, x in rec.items()
                                    if k != "ptxas"}}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(card)
    return 0
