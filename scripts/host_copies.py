#!/usr/bin/env python3
"""Device-to-host copies of 1 GiB on one GPU: the rate into each kind of
host memory, and a caller that keeps every decoded output.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/host_copies.py [--tree DIR] [--seed N] [--keep K] \\
        [--out FILE]

DIR is a checkout of this repository (default: the repository itself);
its huffman_tpu_torch is the one imported.  The input is the benchmark's
pavle-1g traffic (bench_torch/gen.py), drawn on the card from the seed.

  rates   1 GiB from the card, five times each, into fresh pageable
          memory (Tensor.cpu()), into one pageable array whose pages are
          already faulted in, and into one pinned tensor; and the first
          pinned allocation of 1 GiB.  Host clock, the card synchronized
          before and after each copy.
  reads   the container's big-endian swap of a 300 MiB stream
          (container.dumps' container.words) read from each of those
          three kinds of memory, right after the copy into it, five times.
  keep    api.encode once, then api.decode K times, every output held
          and compared with the input: each call's wall, and the counts
          of the tree's pool of host blocks after it (transfer.host_pool,
          api.host_pool in trees before the copy layer had its module;
          timing.host_blocks) where the tree has one.

Prints one JSON line, written to FILE too where given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _timed(fn, reps: int) -> list[float]:
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def rates(src) -> dict:
    import numpy as np
    import torch
    n = src.numel()
    t0 = time.perf_counter()
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    alloc_s = time.perf_counter() - t0
    reused = torch.from_numpy(np.empty(n, np.uint8))
    reused.copy_(src)                   # faults its pages in
    return {"bytes": n, "pinned_alloc_s": alloc_s,
            "fresh_pageable_s": _timed(lambda: src.cpu(), 5),
            "reused_pageable_s": _timed(lambda: reused.copy_(src), 5),
            "pinned_s": _timed(lambda: pinned.copy_(src), 5),
            "reads": reads(src, pinned, reused)}


def reads(src, pinned, reused, nbytes: int = 300 * 2**20) -> dict:
    import numpy as np
    part = src[:nbytes]
    homes = {"fresh_pageable_s": lambda: part.cpu(),
             "reused_pageable_s": lambda: reused[:nbytes].copy_(part),
             "pinned_s": lambda: pinned[:nbytes].copy_(part)}
    out = {k: [] for k in homes}
    for _ in range(5):
        for name, land in homes.items():
            words = land().numpy().view(np.uint32)
            t0 = time.perf_counter()
            words.astype(">u4").tobytes()
            out[name].append(time.perf_counter() - t0)
    return out


def keep(arr, calls: int) -> dict:
    import importlib.util

    import numpy as np
    from huffman_tpu_torch import api
    from huffman_tpu_torch.utils import timing
    enc = api.encode(arr, device="cuda")
    blocks = getattr(timing, "host_blocks", None)
    layer = (importlib.import_module("huffman_tpu_torch.transfer")
             if importlib.util.find_spec("huffman_tpu_torch.transfer")
             else api)
    pool = getattr(layer, "host_pool", None)
    held, walls, counts = [], [], []
    for _ in range(calls):
        t0 = time.perf_counter()
        held.append(api.decode(enc, device="cuda"))
        walls.append(time.perf_counter() - t0)
        if blocks is not None:
            counts.append(dict({k: c.n for k, c in blocks.items()},
                               pinned_bytes=pool.pinned_bytes))
    ok = all(np.array_equal(out, arr) for out in held)
    return {"walls_s": walls, "host_blocks": counts, "outputs_equal": ok}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=str(ROOT))
    p.add_argument("--seed", type=int, default=3141000017)
    p.add_argument("--keep", type=int, default=6)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    from bench_torch import gen
    traffic = json.loads((ROOT / "bench_torch" / "traffic" /
                          "pavle-1g.json").read_text())
    src = gen.generate(traffic, args.seed, "cuda")
    arr = src.cpu().numpy()
    result = {"tree": args.tree, "seed": args.seed,
              "device": torch.cuda.get_device_name(0),
              "rates": rates(src), "keep": keep(arr, args.keep)}
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0 if result["keep"]["outputs_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
