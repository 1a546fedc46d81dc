"""The control and the planted faults that the comparison must catch.

    python3 bench_torch/control.py --workload NAME --seeds A,B,C
        [--modes control,altered_word,...] [--seconds S] [--device cuda]

Each mode puts something in the program's place for a run of the cell at
its own size (a short window), and prints one JSON line a mode and seed
with the compared numbers; the benchmark's own runs never do this.

  sound         nothing: the program as it is (the lower readings)
  control       the plain reference codec, the code-length cap one bit
                lower (11 for 12), in the program's place: a coarser cap
                a speed change might be tempted by; lossless, but it
                breaks the configuration's stated codebook and stream
  altered_word  one bit of one encoded word flipped where it is produced
                (the dense pack's or the wide emit's output)
  altered_byte  one decoded byte flipped where it is produced (K4's or
                K8's output)
  half_dropped  the decoder's second half of blocks or tiles left unwritten
  unchanged     the decoder returns its output buffer unwritten
  no_exchange   (sharded) each card packs as if it started the stream: the
                shard bases are not exchanged
The position of a flipped bit or byte is drawn from the seed.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench_torch import harness  # noqa: E402
from bench_torch.reference import dense as ref_dense  # noqa: E402
from bench_torch.reference import wide as ref_wide  # noqa: E402

DECODERS = {"dense": ("dense_decode", "decode_blocks"),
            "sharded": ("dense_decode", "decode_blocks"),
            "wide": ("wide_decode", "decode_tiles")}
PRODUCERS = {"dense": ("pack2", "pack_blocks"),
             "sharded": ("pack2", "pack_blocks"),
             "wide": ("wide_emit", "emit_planes")}


class ReferenceSystem:
    """The configuration's plain reference, with its cap one bit lower, in
    the program's place."""

    def __init__(self, cell, device: str):
        self.config = dict(cell.config,
                           max_code_len=cell.config["max_code_len"] - 1)
        self.wide = cell.config["reference"] == "wide"
        self.devices = [torch.device(device, 0) if device == "cuda"
                        else torch.device(device)]

    def encode(self, arr):
        x = torch.from_numpy(arr).to(self.devices[0])
        if self.wide:
            lengths, _ = ref_wide.choose_lengths(x, self.config)
            tile_words, bases, payload, _ = ref_wide.encode(x, lengths)
            return (x.numel(), lengths, tile_words, bases, payload), {}
        lengths, _ = ref_dense.choose_lengths(x, self.config)
        block_bits, words = ref_dense.encode(x, lengths,
                                             self.config["block_bytes"])
        return (x.numel(), lengths, block_bits, words), {}

    def dumps(self, enc) -> bytes:
        if self.wide:
            return ref_wide.dumps(enc[0], self.config, *enc[1:])
        return ref_dense.dumps(enc[0], self.config, *enc[1:])

    def loads(self, blob: bytes):
        return (ref_wide if self.wide else ref_dense).loads(
            blob, self.devices[0])

    def decode(self, enc):
        if self.wide:
            return ref_wide.decode(*enc).cpu().numpy()
        return ref_dense.decode(*enc, self.config["block_bytes"]).cpu().numpy()


@contextlib.contextmanager
def patched(module, name: str, wrap):
    original = getattr(module, name)
    setattr(module, name, wrap(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def _after(fn, change):
    def wrapped(*args, **kwargs):
        return change(fn(*args, **kwargs))
    return wrapped


def _flip(seed: int):
    """Flip bit 0 of an element of the output's first row (a decoder's
    first block or tile, whose bytes are all the input's)."""
    def change(out: torch.Tensor) -> torch.Tensor:
        out = out.clone()
        row = out.view(out.shape[0], -1)[0] if out.dim() > 1 else out
        row[int(np.random.default_rng(seed).integers(row.numel()))] ^= 1
        return out
    return change


def _drop_half(out: torch.Tensor) -> torch.Tensor:
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


def fault(mode: str, system_name: str, seed: int):
    """A context that plants `mode` in the program."""
    if mode in ("altered_byte", "half_dropped", "unchanged"):
        mod, fn = DECODERS[system_name]
        change = {"altered_byte": _flip(seed), "half_dropped": _drop_half,
                  "unchanged": torch.zeros_like}[mode]
    elif mode == "altered_word":
        mod, fn = PRODUCERS[system_name]
        change = _flip(seed)
    elif mode == "no_exchange" and system_name == "sharded":
        from huffman_tpu_torch.parallel import pipeline

        def no_bases(shard_bases):
            def wrapped(block_bits, mesh):
                totals, bases = shard_bases(block_bits, mesh)
                return totals, np.zeros_like(bases)
            return wrapped
        return patched(pipeline, "shard_bases", no_bases)
    else:
        raise ValueError(f"no fault {mode!r} for the {system_name} system")
    module = importlib.import_module(f"huffman_tpu_torch.ops.cuda.{mod}")
    return patched(module, fn, lambda f: _after(f, change))


def run_mode(cell, mode: str, seed: int, seconds: float, device: str):
    t0 = time.perf_counter()
    if mode == "sound":
        return harness.run_cell(cell, seed, seconds, False, device, t0)
    if mode == "control":
        return harness.run_cell(cell, seed, seconds, False, device, t0,
                                ReferenceSystem(cell, device))
    with fault(mode, cell.config["system"], seed):
        return harness.run_cell(cell, seed, seconds, False, device, t0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="control,altered_word,altered_byte,"
                                      "half_dropped,unchanged")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            r = run_mode(cell, mode, seed, args.seconds, args.device)
            print(json.dumps({"workload": cell.name, "mode": mode,
                              "seed": seed, "correct": r["correct"],
                              "attempted": r["attempted"],
                              "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
