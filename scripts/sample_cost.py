#!/usr/bin/env python3
"""The card path's encode wall on a sampled 1 GiB tensor, where the
sample misses a byte and where it holds every byte.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/sample_cost.py [--tree DIR] [--seed N] [--reps R] \\
        [--out FILE]

DIR is a checkout of this repository (default: the repository itself);
its huffman_tpu_torch is the one imported, so that two trees are compared
by running the script once for each, in turns, in one call.  The input is
the benchmark's pavle-1g-device traffic (bench_torch/gen.py), drawn on the
card from the seed, in two forms:

  drawn    as drawn: its rarest bytes are mostly outside the sample of
           every 16th block (api.SAMPLE_EVERY), so the sample misses;
  holds    the same bytes with each byte value that the sample lacks
           written once into block 0, which the sample reads, so that the
           sample holds.

Each form is encoded (api.encode_traced of the tensor) and its container
made (container.dumps_device) three times to warm up, then R times timed
on the host clock with the card synchronized before and after: the encode
alone and encode + dumps_device, as the benchmark's encode_GBps counts
them.  Then one roundtrip is held to the input.  Prints one JSON line
(walls, their medians, the encode's trace, the container's size and
CRC-32), written to FILE too where given.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _synced(fn, device):
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def holding(x, every: int, block_bytes: int):
    """x with each byte value that its sample lacks written over the first
    bytes of block 0, and the count of those values."""
    import torch
    from huffman_tpu_torch.ops.histogram import histogram
    nb = x.numel() // block_bytes
    sample = x[: nb * block_bytes].view(nb, block_bytes)[::every]
    lacking = ((histogram(x) > 0) & (histogram(sample) == 0)).nonzero()
    out = x.clone()
    out[: lacking.numel()] = lacking.reshape(-1).to(torch.uint8)
    return out, int(lacking.numel())


def measure(api, container, x, reps: int) -> dict:
    import numpy as np
    import torch

    def encode():
        return api.encode_traced(x, device=x.device)

    for _ in range(3):
        enc, _ = encode()
        container.dumps_device(enc)
    enc_s, both_s = [], []
    for _ in range(reps):
        (enc, trace), a = _synced(encode, x.device)
        buf, b = _synced(lambda: container.dumps_device(enc), x.device)
        enc_s.append(a)
        both_s.append(a + b)
    back = api.decode(container.loads_device(buf), device=x.device)
    crc = buf[-4:].cpu().numpy().view(np.uint32)[0]
    return {"trace": {"sampled": trace.sampled, "rebuilt": trace.rebuilt,
                      "capacities_tried": list(trace.capacities_tried)},
            "encode_s": enc_s, "encode_dumps_s": both_s,
            "median_encode_s": statistics.median(enc_s),
            "median_encode_dumps_s": statistics.median(both_s),
            "container_bytes": int(buf.numel()),
            "container_crc32": int(crc),
            "roundtrip_exact": bool(torch.equal(back, x))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=str(ROOT))
    p.add_argument("--seed", type=int, default=3141000017)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    from bench_torch import gen
    from huffman_tpu_torch import api, container
    traffic = json.loads((ROOT / "bench_torch" / "traffic" /
                          "pavle-1g-device.json").read_text())
    drawn = gen.generate(traffic, args.seed, "cuda")
    held, planted = holding(drawn, api.SAMPLE_EVERY, 1024)
    result = {"tree": args.tree, "seed": args.seed, "reps": args.reps,
              "device": torch.cuda.get_device_name(0),
              "planted_values": planted,
              "drawn": measure(api, container, drawn, args.reps),
              "holds": measure(api, container, held, args.reps)}
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    ok = all(result[k]["roundtrip_exact"] for k in ("drawn", "holds"))
    return 0 if ok and not result["holds"]["trace"]["rebuilt"] else 1


if __name__ == "__main__":
    sys.exit(main())
