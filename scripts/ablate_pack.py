#!/usr/bin/env python3
"""Ablations of the dense pack, K2 + K3 (csrc/pack.cu), on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/ablate_pack.py --tree DIR [--variants a,b] \\
        [--data DIR2] [--out FILE]

DIR is a checkout of this repository (default: the repository itself),
so the same script times an older commit's pack from a `git archive` of
it.  For each variant below it copies DIR/huffman_tpu_torch into a
temporary directory, rewrites csrc/pack.cu there by exact text
substitution (a variant whose text is not found is reported as not
applicable), builds that copy in a child process, and times the pack
through its wrapper, and the offset scan (ops/scan.py
exclusive_bit_offsets) alone, at 64 MiB and 1 GiB of the main path's
profile (testdata.entropy_stream, 32 symbols, H = 2.2066: 65,536 and
1,048,576 blocks of 1 KiB at 256 words of capacity; --data keeps the
inputs between runs, and shares them with the other ablation scripts).
K1's streams and the offsets are made once per size by the copy's own K1
and scan.  The calls are captured in a CUDA graph and replayed
(chip_smoke.graph_ms).  The variants in EXACT compute the same stream and
are held to the plain version (ops.pack.pack_blocks) exactly, 65,536
blocks at a time; the other variants compute something else on purpose,
and their times say what the removed work cost.  Nothing of the repository's own
build or sources changes.

Variants, and the TPU probe under experiments/ that each stands for:
  baseline      the kernel as it is (no substitution: it applies to any
                tree).
  atomic_seams  each block's first and last words go straight to device
                memory by atomicOr, into an output that the entry point
                zero-fills first (cudaMemsetAsync, inside the timed graph);
                the tile stores the other words one by one: what the
                write-once tile saves (exact).  pallas_pack_v1.py:237
                align_pallas (a carried partial row in place of the seam
                atomicOr).
  per_block     a batch holds one block: each block is staged and placed
                on its own, where the tile stages all its blocks at once
                (exact).  pallas_pack_v1.py:118 merge8_pallas (8 block
                streams merged into one superstream before placing).
  handoff       an identity device copy of K1's streams runs before the
                pack, and the pack reads the copy (exact): what a
                kernel-to-kernel handoff of the streams costs.
                probe_pack_fusion.py:301 pallas_handoff.
  copy_only     the tile takes each staged word as it is: no shift and no
                merge, the design's memory traffic alone.
  no_place      the words are staged but not placed: the stream is zeros.
  no_stage      no source word is copied: the placing reads whatever the
                staging buffer holds.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ablation  # noqa: E402  (the shared runner, beside this script)

CHECK_BLOCKS = 65536            # the plain version runs on slices this big
CU = "pack.cu"

# the entry point's signature and launch, in this design and the parent's
_HEAD = "void* stream) {\n"
_ARGS = "(const uint32_t*)streams, (const int32_t*)bits,"
_COPY = """\
  static char* copy = nullptr;
  static long long copy_n = 0;
  const long long n = nb * cap * 4;
  if (copy_n < n) {
    cudaFree(copy);
    if (cudaMalloc(&copy, n) != cudaSuccess) return 2;
    copy_n = n;
  }
  cudaMemcpyAsync(copy, streams, n, cudaMemcpyDeviceToDevice,
                  (cudaStream_t)stream);
"""
_HANDOFF = [(_HEAD, _HEAD + _COPY),
            (_ARGS, _ARGS.replace("streams", "copy"))]

_SEAM = ("          atomicOr(&tile[q.rel + j], __funnelshift_r(cur, prev, "
         "q.sh));\n")
_STORE = """\
      if (i + 4 <= tw) {
        *reinterpret_cast<uint4*>(out + t0 + i) = *w;
      } else {
        for (int k = i; k < tw; ++k) out[t0 + k] = tile[k];
      }
"""
# a seam word stays zero in the tile, so the store skips it
_ATOMIC_SEAMS = [
    (_HEAD, _HEAD + "  cudaMemsetAsync(out, 0, n_out * 4, "
                    "(cudaStream_t)stream);\n"),
    (_SEAM, _SEAM.replace("&tile[q.rel + j]", "out + t0 + q.rel + j")),
    (_STORE, """\
      for (int k = i; k < min(i + 4, tw); ++k)
        if (tile[k]) out[t0 + k] = tile[k];
""")]
_FIT = "          covers && incl * U <= PACK_STAGE);\n"
_PER_BLOCK = [(_FIT, _FIT.replace(");", " && tid == 0);"))]
_INTERIOR = """\
          tile[q.rel + j] = __funnelshift_r(stage[at + j], stage[at + j - 1],
                                            q.sh);
"""
_COPY_ONLY = [(_INTERIOR, "          tile[q.rel + j] = stage[at + j];\n"),
              (_SEAM, "          tile[q.rel + j] = cur;\n")]
# the loops over a batch's blocks that place and that stage their words
_PLACE = ("      // 4. shift each block's words to its phase, into the tile\n"
          "      for (int i = warp; i < n_fit; i += PACK_WARPS) {\n")
_STAGE = ("      for (int i = warp; i < n_fit; i += PACK_WARPS) {\n"
          "        const PackSlot& q = slot[i];\n")

# variant -> {kernel source: [alternative, ...]}: an alternative is a list
# of (old text, new text) pairs
VARIANTS = {
    "baseline": {},
    "atomic_seams": {CU: [_ATOMIC_SEAMS]},
    "per_block": {CU: [_PER_BLOCK]},
    "handoff": {CU: [_HANDOFF]},
    "copy_only": {CU: [_COPY_ONLY]},
    "no_place": {CU: [[(_PLACE, _PLACE.replace("i < n_fit", "i < 0"))]]},
    "no_stage": {CU: [[(_STAGE, _STAGE.replace("i < n_fit", "i < 0"))]]},
}
# variants that compute the same result, and are held to the plain version
EXACT = {"baseline", "atomic_seams", "per_block", "handoff"}
# the TPU probes (experiments/ file:line) that each variant stands for
STANDS_FOR = {
    "baseline": [],
    "atomic_seams": ["pallas_pack_v1.py:237"],
    "per_block": ["pallas_pack_v1.py:118"],
    "handoff": ["probe_pack_fusion.py:301"],
    "copy_only": [],
    "no_place": [],
    "no_stage": [],
}


def patch_tree(tree: str, dst: str, variant: str) -> dict:
    """Copy tree's package to dst and apply the variant; returns which
    kernel sources the variant applies to."""
    return ablation.patch_tree(tree, dst, VARIANTS[variant])


def child(pkg_root: str, data_dir: str, check: bool) -> dict:
    """Build the package copy at pkg_root and time the pack and the offset
    scan on each size."""
    sys.path.insert(0, pkg_root)
    sys.path.append(ablation.REPO)      # chip_smoke: timer, bound formulas
    import torch
    from chip_smoke import bound, dense_work, graph_ms
    from huffman_tpu_torch import api
    from huffman_tpu_torch.config import CodecConfig
    from huffman_tpu_torch.ops import pack as p_pack
    from huffman_tpu_torch.ops.cuda import _build
    from huffman_tpu_torch.ops.cuda import encode as k_encode
    from huffman_tpu_torch.ops.cuda import pack2 as k_pack
    from huffman_tpu_torch.ops.encode import BITS_MASK
    from huffman_tpu_torch.ops.scan import exclusive_bit_offsets
    if not _build.PKG.startswith(pkg_root):
        raise RuntimeError(f"imported {_build.PKG}, not the copy")
    log = _build.build()
    dev = torch.device("cuda")
    lines = log.splitlines()
    res = {"ptxas": [" ".join(x.strip() for x in lines[i: i + 4])
                     for i, ln in enumerate(lines)
                     if "Compiling entry" in ln and "pack" in ln]}
    cfg = CodecConfig()
    cap = cfg.capacity_words
    for name in ablation.SIZES:
        data = np.load(os.path.join(data_dir, f"{name}.npy"))
        blocks, valid = api.device_blocks(data, cfg, dev)
        cb = api.build_codebook(data, cfg, dev)
        codes, lengths = api.codebook_tensors(cb, dev)
        streams, bits = k_encode.encode_blocks(blocks, codes, lengths, valid,
                                               cap)
        del blocks, valid
        bits = bits & BITS_MASK
        offs = exclusive_bit_offsets(bits)
        n_words = int(offs.total_words)
        nb = bits.shape[0]

        def pack():
            return k_pack.pack_blocks(streams, bits, offs.word_base,
                                      offs.bit_shift, n_words)
        words = pack()
        if check:
            # the plain version on each slice of blocks, ORed into place
            want = torch.zeros_like(words)
            starts = offs.word_base * 32 + offs.bit_shift
            for i in range(0, nb, CHECK_BLOCKS):
                j = min(nb, i + CHECK_BLOCKS)
                w0 = int(offs.word_base[i])
                end = int(starts[j]) if j < nb else int(offs.total_bits)
                n = -(-(end - 32 * w0) // 32)
                want[w0: w0 + n] |= p_pack.pack_blocks(
                    streams[i:j], bits[i:j], offs.word_base[i:j] - w0,
                    offs.bit_shift[i:j], n)
            if not torch.equal(words, want):
                raise RuntimeError(f"{name}: the pack differs from the "
                                   "plain version")
            del want, starts
        work = dense_work(nb, cfg.block_bytes, cap, bits, n_words, 1)["pack"]
        res[name] = {"pack_ms": graph_ms(pack, ablation.REPS[name]),
                     "scan_ms": graph_ms(lambda: exclusive_bit_offsets(bits),
                                         ablation.REPS[name]),
                     "pack_bytes": work[0], "pack_bound_ms": bound(work)[0],
                     "blocks": nb, "words": n_words, "exact_checked": check}
        del streams, bits, offs, words
        torch.cuda.empty_cache()
    return res


if __name__ == "__main__":
    sys.exit(ablation.main(__file__, __doc__, VARIANTS, EXACT, child))
