#!/usr/bin/env python3
"""Ablations of the byte histogram (csrc/histogram.cu) on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/ablate_hist.py --tree DIR [--variants a,b] \\
        [--data DIR2] [--out FILE]

DIR is a checkout of this repository (default: the repository itself).
For each kernel variant below it copies DIR/huffman_tpu_torch into a
temporary directory, rewrites csrc/histogram.cu there by exact text
substitution (a variant whose text is not found is reported as not
applicable), builds that copy in a child process, and times the histogram
through its wrapper by CUDA-graph replay (chip_smoke.graph_ms) at 64 MiB
and 1 GiB of three inputs: the main path's profile
(testdata.entropy_stream, 32 symbols, H = 2.2066, its top byte ~45% of the
input; --data keeps it between runs and shares it with the other ablation
scripts), uniform bytes and one repeated byte (both made on the card).
The variants in EXACT count the same bins and are held to torch.bincount
exactly; the others compute something else on purpose.  Nothing of the
repository's own build or sources changes.

Kernel variants:
  baseline     the kernel as it is: 256 32-bit bins a warp in shared
               memory, one shared atomicAdd a byte.
  cta_bins     one copy of the bins a CTA, shared by its four warps: the
               reference GPU histogram's design, hist.cu:38-51 (exact).
  warp_match   the lanes that hold the same byte combined first
               (__match_any_sync): one leader adds the group's __popc
               (exact).
  cta_match    cta_bins with match-any aggregation (exact).
  thread8      256 8-bit counters private to each thread, four to a word
               and interleaved so that a warp's increments hit 32 banks
               whatever the bytes, folded into registers by warp
               reductions every 224 bytes a thread (exact).
  unroll1      one 16-byte load a lane in flight in place of two (exact).
  unroll4      four (exact).
  threads256   CTAs of 256 threads in place of 128 (exact).
  read_only    the loads alone, no counting: the memory system's rate for
               this grid.
The TPU's own formulations, as PyTorch tensor-core programs (no rewrite;
times from CUDA events around back-to-back calls, as for bincount, whose
count of the bins syncs the host and cannot be captured in a graph):
  bincount     torch.bincount, the library call the port used to make; its
               1 GiB call also runs under torch.profiler, and the record
               lists its device kernels by time.
  onehot       the nibble one-hot contraction of experiments/probe_hist.py:63
               (cur, histogram_onehot): (N, 16) bf16 one-hots of each
               byte's high and low nibble contracted over N on the tensor
               cores with float32 sums, in tiles of 2^22 bytes (exact below
               2^24 a tile).
  ata_i8       the A^T A form of experiments/probe_hist.py:69 (ata): the
               (128, T) int8 one-hots of a 32-bit word's eight nibbles,
               A^T A in int32 on the tensor cores (torch._int_mm), the
               histogram the sum of its four (high, low) nibble blocks; in
               tiles of 2^20 words.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ablation  # noqa: E402  (the shared runner, beside this script)

CU = "histogram.cu"
INPUTS = ("main", "uniform", "one_byte")
ONEHOT_TILE = 1 << 22           # bytes a one-hot contraction (f32 exact)
ATA_TILE_WORDS = 1 << 20        # words an A^T A product

_ADD = "    atomicAdd(bins + b, 1u);\n"
_MINE = "  uint32_t* mine = bins + warp * 256;\n"
_MATCH = """\
    const uint32_t peers = __match_any_sync(__activemask(), b);
    if ((threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(bins + b, (uint32_t)__popc(peers));
"""
_CTA = [(_MINE, "  uint32_t* mine = bins;\n")]
_UNROLL = "constexpr int HIST_UNROLL = 2;"

# thread8: the bins become 64 words a thread, byte b in bits
# [8 (b >> 6), 8 (b >> 6) + 8) of word (b & 63) of the thread's column
# (word w of thread t at w * HIST_THREADS + t), folded into registers
# before a counter can wrap; the warps' registers meet in the bins at the
# end, which the merge then sums as it does the warps' bins
_WORDS = "constexpr int HIST_WORDS = HIST_WARPS * 256;     // the bins' words\n"
_FLUSH8 = """\
constexpr int HIST_WORDS = 64 * HIST_THREADS;
constexpr int HIST_FLUSH_LOADS = 255 / (16 * HIST_UNROLL) * HIST_UNROLL;

// acc[4 h + j] of lane L: bin (L + 32 h) + 64 j
__device__ __forceinline__ void flush8(uint32_t* col, int lane,
                                       uint32_t (&acc)[8]) {
  __syncwarp();
#pragma unroll
  for (int w = 0; w < 64; ++w) {
    const uint32_t x = col[w * HIST_THREADS];
    col[w * HIST_THREADS] = 0;
    const uint32_t even = __reduce_add_sync(0xffffffffu, x & 0x00ff00ffu);
    const uint32_t odd = __reduce_add_sync(0xffffffffu,
                                           (x >> 8) & 0x00ff00ffu);
    if (lane == (w & 31)) {
      uint32_t* a = acc + 4 * (w >> 5);
      a[0] += even & 0xffffu;
      a[1] += odd & 0xffffu;
      a[2] += even >> 16;
      a[3] += odd >> 16;
    }
  }
  __syncwarp();
}
"""
_LOOP_END = """\
        count_word(mine, q[u].w);
      }
    }
  }
"""
_MERGE = "  // one 64-bit add a bin and CTA\n  __syncthreads();\n"
_THREAD8 = [
    (_WORDS, _FLUSH8),
    (_ADD, "    atomicAdd(bins + (b & 63u) * HIST_THREADS, "
           "1u << ((b >> 6) << 3));\n"),
    (_MINE, "  uint32_t* mine = bins + tid;\n"
            "  uint32_t acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
            "  int loads = 0;\n"),
    (_LOOP_END, _LOOP_END[:-4] + """\
    if ((loads += HIST_UNROLL) == HIST_FLUSH_LOADS) {
      flush8(mine, lane, acc);
      loads = 0;
    }
  }
  flush8(mine, lane, acc);
"""),
    (_MERGE, _MERGE + """\
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bins[warp * 256 + lane + 32 * h + 64 * j] += acc[4 * h + j];
  __syncthreads();
"""),
]

# variant -> {kernel source: [alternative, ...]}: an alternative is a list
# of (old text, new text) pairs
VARIANTS = {
    "baseline": {},
    "cta_bins": {CU: [_CTA]},
    "warp_match": {CU: [[(_ADD, _MATCH)]]},
    "cta_match": {CU: [_CTA + [(_ADD, _MATCH)]]},
    "thread8": {CU: [_THREAD8]},
    "unroll1": {CU: [[(_UNROLL, "constexpr int HIST_UNROLL = 1;")]]},
    "unroll4": {CU: [[(_UNROLL, "constexpr int HIST_UNROLL = 4;")]]},
    "threads256": {CU: [[("constexpr int HIST_THREADS = 128;",
                          "constexpr int HIST_THREADS = 256;")]]},
    "read_only": {CU: [[(_ADD, "    if (x == 0x9e3779b9u + k) "
                               "atomicAdd(bins, 1u);\n")]]},
}
# variants that count the same bins, held to torch.bincount
EXACT = set(VARIANTS) - {"read_only"}
# the TPU formulations (experiments/ file:line) that each variant stands for
STANDS_FOR = {**{v: [] for v in VARIANTS},
              "bincount": [], "onehot": ["probe_hist.py:63"],
              "ata_i8": ["probe_hist.py:69"]}


def patch_tree(tree: str, dst: str, variant: str) -> dict:
    """Copy tree's package to dst and apply the variant; returns which
    kernel sources the variant applies to."""
    return ablation.patch_tree(tree, dst, VARIANTS[variant])


def make_input(kind: str, n: int, data_dir: str, device):
    """One of INPUTS, n bytes as a uint8 tensor on `device`: the main
    profile from data_dir's file of that size, uniform bytes from a seeded
    generator, or one repeated byte."""
    import torch
    if kind == "main":
        name = next(k for k, v in ablation.SIZES.items() if v == n)
        return torch.from_numpy(np.load(os.path.join(data_dir,
                                                     f"{name}.npy"))).to(device)
    if kind == "uniform":
        g = torch.Generator(device=device).manual_seed(2)
        return torch.randint(0, 256, (n,), generator=g, dtype=torch.uint8,
                             device=device)
    return torch.full((n,), 7, dtype=torch.uint8, device=device)


def onehot_hist(data, tile: int = ONEHOT_TILE):
    """histogram_onehot's nibble contraction: per tile of `tile` bytes,
    onehot16(high)^T onehot16(low) in bf16 with float32 sums (exact below
    2^24 a tile), summed in int64.  len(data) a multiple of `tile`."""
    import torch
    iota = torch.arange(16, device=data.device, dtype=torch.uint8)
    acc = torch.zeros((16, 16), dtype=torch.int64, device=data.device)
    for t in data.view(-1, tile):
        hi = ((t >> 4)[:, None] == iota).to(torch.bfloat16)
        lo = ((t & 15)[:, None] == iota).to(torch.bfloat16)
        if data.is_cuda:
            h = torch.mm(hi.t(), lo, out_dtype=torch.float32)
        else:
            h = hi.t().float() @ lo.float()
        acc += h.to(torch.int64)
    return acc.reshape(256)


def ata_hist(data, tile_words: int = ATA_TILE_WORDS):
    """probe_hist's A^T A: per tile, the (128, T) int8 one-hots of each
    word's eight nibbles (row 16 g + v: nibble g equals v), A A^T in int32;
    the histogram is the sum of the four (high, low) blocks (2k + 1, 2k).
    len(data) a multiple of 4 * tile_words."""
    import torch
    lane = torch.arange(128, device=data.device, dtype=torch.int32)
    shifts, targets = (4 * (lane // 16))[:, None], (lane % 16)[:, None]
    acc = torch.zeros((128, 128), dtype=torch.int64, device=data.device)
    for w in data.view(torch.int32).view(-1, tile_words):
        at = (((w[None, :] >> shifts) & 15) == targets).to(torch.int8)
        acc += torch._int_mm(at, at.t()).to(torch.int64)
    return sum(acc[16 * (2 * k + 1): 16 * (2 * k + 2),
                   16 * (2 * k): 16 * (2 * k + 1)]
               for k in range(4)).reshape(256)


def child(pkg_root: str, data_dir: str, check: bool) -> dict:
    """Build the package copy at pkg_root and time its histogram on each
    size and input."""
    sys.path.insert(0, pkg_root)
    sys.path.append(ablation.REPO)      # chip_smoke: timer, bound formulas
    import torch
    from chip_smoke import HBM_BYTES_PER_S, graph_ms
    from huffman_tpu_torch.ops.cuda import _build
    from huffman_tpu_torch.ops.cuda import histogram as k_hist
    if not _build.PKG.startswith(pkg_root):
        raise RuntimeError(f"imported {_build.PKG}, not the copy")
    log = _build.build()
    dev = torch.device("cuda")
    lines = log.splitlines()
    res = {"ptxas": [" ".join(x.strip() for x in lines[i: i + 4])
                     for i, ln in enumerate(lines)
                     if "Compiling entry" in ln and "histogram" in ln]}
    for name, n in ablation.SIZES.items():
        res[name] = {"bound_ms": n / HBM_BYTES_PER_S * 1e3}
        for kind in INPUTS:
            data = make_input(kind, n, data_dir, dev)
            got = k_hist.histogram(data, n)
            if check and not torch.equal(
                    got, torch.bincount(data, minlength=256)):
                raise RuntimeError(f"{name} {kind}: the histogram differs "
                                   "from torch.bincount")
            res[name][kind] = graph_ms(lambda: k_hist.histogram(data, n),
                                       ablation.REPS[name])
            del data
        torch.cuda.empty_cache()
    return res


def _formulation(fn, trace: bool = False):
    """The record of a PyTorch formulation `fn`: ms by size and input from
    CUDA events, each result held to torch.bincount."""
    def run(tmp: str, data_dir: str) -> dict:
        import torch
        from chip_smoke import HBM_BYTES_PER_S, cuda_ms
        dev = torch.device("cuda")
        res = {}
        for name, n in ablation.SIZES.items():
            res[name] = {"bound_ms": n / HBM_BYTES_PER_S * 1e3}
            for kind in INPUTS:
                data = make_input(kind, n, data_dir, dev)
                if not torch.equal(fn(data),
                                   torch.bincount(data, minlength=256)):
                    raise RuntimeError(f"{name} {kind}: differs from "
                                       "torch.bincount")
                res[name][kind] = cuda_ms(lambda: fn(data), 2)
                if trace and name == "1GiB" and kind == "main":
                    res[name]["trace"] = _trace(lambda: fn(data))
                del data
                torch.cuda.empty_cache()
        return res
    return run


def _trace(fn) -> list:
    """fn's device kernels under torch.profiler, by total device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [{"name": e.key[:120], "calls": e.count,
             "device_ms": e.device_time_total / 1e3}
            for e in prof.key_averages() if e.device_time_total]
    return sorted(rows, key=lambda r: -r["device_ms"])[:12]


def _bincount(data):
    import torch
    return torch.bincount(data, minlength=256)


def extras() -> dict:
    return {"bincount": _formulation(_bincount, trace=True),
            "onehot": _formulation(onehot_hist),
            "ata_i8": _formulation(ata_hist)}


if __name__ == "__main__":
    sys.exit(ablation.main(__file__, __doc__, VARIANTS, EXACT, child,
                           extras()))
