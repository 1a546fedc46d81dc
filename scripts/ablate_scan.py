#!/usr/bin/env python3
"""Ablations of the offset scan (csrc/scan.cu) on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/ablate_scan.py [--tree DIR] [--variants a,b] \\
        [--data DIR2] [--out FILE]

DIR is a checkout of this repository (default: the repository itself).
For each variant below it copies DIR/huffman_tpu_torch into a temporary
directory, rewrites csrc/scan.cu there by exact text substitution (a
variant whose text is not found is reported as not applicable), builds
that copy in a child process, and times by CUDA-graph replay
(chip_smoke.graph_ms), at 64 MiB and 1 GiB of the main path's profile
(testdata.entropy_stream, 32 symbols, H = 2.2066: 65,536 and 1,048,576
blocks of 1 KiB; --data keeps the inputs between runs and shares them
with the other ablation scripts):
  - the dense offsets (ops.scan.exclusive_bit_offsets) of the block bits
    that the copy's own K1 gives at 256 words of capacity;
  - in the same replay window, the plain version (the int64 torch.cumsum
    chain, ops.scan.exclusive_bit_offsets_plain) and torch.cumsum alone,
    so that every variant's record carries its own yardsticks;
  - the wide payload offsets (wide.payload_offsets' kernel) of 256 and
    4096 tiles of seeded tile words (a 64 MiB and a 1 GiB input's tile
    counts), beside their plain version.
At 1 GiB, torch.profiler also lists the device kernels (and memsets) of
one dense scan and of one torch.cumsum, by device time.  The variants in
EXACT compute the same offsets and are held to the plain version exactly,
20 times over at each size; the others compute something else on purpose,
and their times say what the removed work cost.  Nothing of the
repository's own build or sources changes.

Variants:
  baseline       the kernel as it is: tiles of 4096 counts, look-back by
                 warp 0 over 32 predecessors at a time, status words
                 stored and loaded with .relaxed.gpu, the int64 offsets
                 stored through shared memory.
  acq_rel        the status words stored with st.release.gpu and loaded
                 with ld.acquire.gpu (exact).
  strided_store  each lane stores its four int64 offsets from registers,
                 two 16-byte stores 32 bytes apart across the warp, as the
                 first design did (exact).
  memset_twice   the entry clears the workspace twice: what one memset of
                 the status words costs (exact).
  no_lookback    each tile takes 0 as its exclusive prefix: the loads, the
                 tile's own scan and the stores, without the chain of
                 tiles.
  no_store       no offset or bit shift is written (the totals are): the
                 loads, the scans and the look-back alone.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ablation  # noqa: E402  (the shared runner, beside this script)

CU = "scan.cu"
CHECK_REPEATS = 20              # exact checks of a variant at each size
WIDE_TILES = {"64MiB": 256, "1GiB": 4096}

_LD, _ST = "ld.relaxed.gpu.global.u64", "st.relaxed.gpu.global.u64"
_LOOK = "      excl = look_back(status, tile, agg, lane);\n"
_MEMSET = """\
  const cudaError_t e =
      cudaMemsetAsync(work, 0, (size_t)(tiles + 1) * sizeof(*status), s);
"""
_TO_SLICE = """\
    ulonglong2* to =
        reinterpret_cast<ulonglong2*>(slice + 4 * (32 * v + lane));
    to[0] = make_ulonglong2(o[0], o[1]);
    to[1] = make_ulonglong2(o[2], o[3]);
"""
_FROM_REGS = """\
    if (i + 4 <= n) {
      reinterpret_cast<ulonglong2*>(out + i)[0] = make_ulonglong2(o[0], o[1]);
      reinterpret_cast<ulonglong2*>(out + i)[1] = make_ulonglong2(o[2], o[3]);
    } else {
      for (int k = 0; k < 4 && i + k < n; ++k) out[i + k] = (long long)o[k];
    }
"""
_PAIRS = "  for (int h = 0; h < WARP_ITEMS / 64; ++h) {\n"
_NO_PAIRS = "  for (int h = 0; h < 0; ++h) {\n"

# variant -> {kernel source: [alternative, ...]}: an alternative is a list
# of (old text, new text) pairs
VARIANTS = {
    "baseline": {},
    "acq_rel": {CU: [[(_LD, _LD.replace("relaxed", "acquire")),
                      (_ST, _ST.replace("relaxed", "release"))]]},
    "strided_store": {CU: [[(_TO_SLICE, _FROM_REGS), (_PAIRS, _NO_PAIRS)]]},
    "memset_twice": {CU: [[(_MEMSET, "  cudaMemsetAsync(work, 0, (size_t)"
                                     "(tiles + 1) * sizeof(*status), s);\n"
                            + _MEMSET)]]},
    "no_lookback": {CU: [[(_LOOK, "      excl = 0;\n")]]},
    "no_store": {CU: [[(_TO_SLICE, ""), (_PAIRS, _NO_PAIRS),
                       ("    if (shift && i + 4 <= n) {\n",
                        "    if (!scale) {\n"),
                       ("    } else if (shift) {\n",
                        "    } else if (!scale) {\n")]]},
}
EXACT = set(VARIANTS) - {"no_lookback", "no_store"}


def patch_tree(tree: str, dst: str, variant: str) -> dict:
    """Copy tree's package to dst and apply the variant; returns which
    kernel sources the variant applies to."""
    return ablation.patch_tree(tree, dst, VARIANTS[variant])


def child(pkg_root: str, data_dir: str, check: bool) -> dict:
    """Build the package copy at pkg_root and time its offset scans on
    each size."""
    sys.path.insert(0, pkg_root)
    sys.path.append(ablation.REPO)      # chip_smoke: timer, bound formulas
    import torch
    from chip_smoke import bound, graph_ms, scan_work
    from huffman_tpu_torch import api
    from huffman_tpu_torch.config import CodecConfig
    from huffman_tpu_torch.ops import scan
    from huffman_tpu_torch.ops.cuda import _build
    from huffman_tpu_torch.ops.cuda import encode as k_encode
    from huffman_tpu_torch.ops.cuda import scan as k_scan
    from huffman_tpu_torch.ops.encode import BITS_MASK
    if not _build.PKG.startswith(pkg_root):
        raise RuntimeError(f"imported {_build.PKG}, not the copy")
    log = _build.build()
    dev = torch.device("cuda")
    lines = log.splitlines()
    res = {"ptxas": [" ".join(x.strip() for x in lines[i: i + 4])
                     for i, ln in enumerate(lines)
                     if "Compiling entry" in ln and "bit_offsets" in ln]}
    cfg = CodecConfig()
    for name in ablation.SIZES:
        data = np.load(os.path.join(data_dir, f"{name}.npy"))
        blocks, valid = api.device_blocks(data, cfg, dev)
        cb = api.build_codebook(data, cfg, dev)
        codes, lengths = api.codebook_tensors(cb, dev)
        streams, bits = k_encode.encode_blocks(blocks, codes, lengths, valid,
                                               cfg.capacity_words)
        del blocks, valid, streams
        bits = bits & BITS_MASK
        g = torch.Generator(device=dev).manual_seed(3)
        tw = torch.randint(0, 20000, (WIDE_TILES[name],), generator=g,
                           dtype=torch.int32, device=dev)
        if check:
            want = scan.exclusive_bit_offsets_plain(bits)
            want_w = scan.payload_offsets_plain(tw)
            for _ in range(CHECK_REPEATS):
                got = scan.exclusive_bit_offsets(bits)
                got_w = k_scan.payload_offsets(tw)
                if not (all(torch.equal(a, b) for a, b in zip(got, want))
                        and all(torch.equal(a, b)
                                for a, b in zip(got_w, want_w))):
                    raise RuntimeError(f"{name}: the scan differs from the "
                                       "plain version")
            del want, want_w, got, got_w
        reps = ablation.REPS[name]
        nb = bits.shape[0]
        res[name] = {
            "scan_ms": graph_ms(lambda: scan.exclusive_bit_offsets(bits),
                                reps),
            "chain_ms": graph_ms(
                lambda: scan.exclusive_bit_offsets_plain(bits), reps),
            "cumsum_ms": graph_ms(
                lambda: torch.cumsum(bits, 0, dtype=torch.int64), reps),
            "wide_tiles": WIDE_TILES[name],
            "wide_ms": graph_ms(lambda: k_scan.payload_offsets(tw), reps),
            "wide_chain_ms": graph_ms(lambda: scan.payload_offsets_plain(tw),
                                      reps),
            "blocks": nb, "bytes": scan_work(nb)[0],
            "bound_ms": bound(scan_work(nb))[0], "exact_checked": check}
        if name == "1GiB":
            res[name]["trace"] = {
                "scan": _trace(lambda: scan.exclusive_bit_offsets(bits)),
                "cumsum": _trace(
                    lambda: torch.cumsum(bits, 0, dtype=torch.int64))}
        del bits, tw
        torch.cuda.empty_cache()
    return res


def _trace(fn) -> list:
    """fn's device kernels and memsets under torch.profiler, by device
    time."""
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
    return sorted(rows, key=lambda r: -r["device_ms"])[:8]


if __name__ == "__main__":
    sys.exit(ablation.main(__file__, __doc__, VARIANTS, EXACT, child))
