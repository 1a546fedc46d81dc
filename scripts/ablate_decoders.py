#!/usr/bin/env python3
"""Ablations of the two decode kernels (K4 dense, K8 wide) on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/ablate_decoders.py --tree DIR [--out FILE]

DIR is a checkout of this repository (default: the repository itself),
so the same script ablates an older commit's kernels from a `git archive`
of it, from the one whose port holds its own golden codec (PR 4) on.  For each variant below it copies DIR/huffman_tpu_torch into a
temporary directory, rewrites the kernel sources there by exact text
substitution (a variant whose text is not found in that tree's kernel is
reported as not applicable), builds that copy in a child process, and
times K4 and K8 through their wrappers with CUDA events at 64 MiB and
1 GiB of the main path's profile (32 symbols, H = 2.2066).  Only the
variants that keep the result are checked for exact output: every other
variant computes something else on purpose, and its time says what the
removed work cost.  Nothing of the repository's own build or sources changes.

Variants:
  baseline    the kernels as they are.
  store_fold  every output store becomes an XOR into a register, written
              once per thread at the end: the cost of the stores.
  src_l1      every stream or payload read goes to its first 4 KiB (an
              L1-resident window): the cost of the reads' misses.
  fold_l1     both: what is left is the table lookups and shifts.
  no_rank     K8 only: the CTA-wide rank of each round becomes a warp-local
              one (no barrier): the cost of the barriers.
  lines128    K8 only, staged output: one CTA per SM with 32 rounds staged
              per store, so each substream's run is a whole 128-byte line
              (the design's two CTAs per SM stage 8 rounds, 32 bytes).
  one_cta     K8 only, staged output: one CTA per SM, 16 rounds staged.
  ring8       K4 only, staged stream: ring quarters of 8 words (stages of
              half the symbols) instead of 16: less shared memory per CTA.
  no_lookup   staged designs: each table lookup becomes a 2- or 3-bit code
              made from the buffer's top bit: the cost of the lookups'
              shared-memory accesses, the chain of shifts kept.
A variant applies to the first design of the kernels (PR 1-2) or to the
staged one (PR 4) where its text is found; store_fold has both forms.
Variants in EXACT compute the same result and are checked against the
input.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ablation  # noqa: E402  (the shared runner, beside this script)


# variant -> {kernel source: [alternative, ...]}: an alternative is a list
# of (old text, new text) pairs, and the first alternative whose every old
# text is in the tree's kernel is applied (PR 1-2 kernels, then PR 4's)
_K4_FOLD = [
    ("uint32_t* dst = (uint32_t*)(out + b * block_bytes);",
     "uint32_t* dst = (uint32_t*)(out + b * block_bytes);\n"
     "    uint32_t fold = 0;"),
    ("      dst[i >> 2] = word;\n    }\n",
     "      fold ^= word;\n    }\n    dst[0] = fold;\n"),
]
_K4_FOLD_STAGED = [
    ("  uint32_t* out32 = reinterpret_cast<uint32_t*>(out);\n",
     "  uint32_t* out32 = reinterpret_cast<uint32_t*>(out);\n"
     "  uint32_t fold = 0;\n"),
    ("out32[(bb * block_bytes + c) / 4 + w] = stage_out[src * PITCH + w];",
     "fold ^= stage_out[src * PITCH + w];"),
    ("      __syncwarp();\n    }\n  }\n}\n",
     "      __syncwarp();\n    }\n  }\n"
     "  out32[blockIdx.x * THREADS + threadIdx.x] = fold;\n}\n"),
]
_K4_L1 = [("stream[wp]", "stream[wp & 1023]")]
_K8_FOLD = [
    ("  int avail = 0;\n", "  int avail = 0;\n  uint32_t fold = 0;\n"),
    ("    dst[j] = word;\n  }\n", "    fold ^= word;\n  }\n  dst[0] = fold;\n"),
]
_K8_FOLD_STAGED = [
    ("  uint32_t* out32 = reinterpret_cast<uint32_t*>(out + t * "
     "WIDE_TILE_BYTES);\n",
     "  uint32_t* out32 = reinterpret_cast<uint32_t*>(out + t * "
     "WIDE_TILE_BYTES);\n  uint32_t fold = 0;\n"),
    ("        out32[(warp * 32 + src) * (WIDE_SUB_BYTES / 4) + j - "
     "(OUT_ROUNDS - 1) +\n              c] = s_out[src * PITCH + c];",
     "        fold ^= s_out[src * PITCH + c];"),
    ("      __syncwarp();\n    }\n  }\n}\n",
     "      __syncwarp();\n    }\n  }\n  out32[k] = fold;\n}\n"),
]
_K8_L1 = [("payload[p0 + pos]", "payload[(p0 + pos) & 1023]"),
          ("payload[p1 + pos]", "payload[(p1 + pos) & 1023]")]
_K8_NO_RANK = [
    ("cta_exclusive_count(pull, s_scan, &total)",
     "__popc(__ballot_sync(0xffffffffu, pull) & ((1u << (k & 31)) - 1u)); "
     "total = 0"),
]
_K8_LINES = [("constexpr int OUT_ROUNDS = 8;", "constexpr int OUT_ROUNDS = 32;"),
             ("constexpr int CTAS_PER_SM = 2;", "constexpr int CTAS_PER_SM = 1;")]
_K8_ONE_CTA = [("constexpr int OUT_ROUNDS = 8;", "constexpr int OUT_ROUNDS = 16;"),
               ("constexpr int CTAS_PER_SM = 2;", "constexpr int CTAS_PER_SM = 1;")]
_K4_RING8 = [("constexpr int QW = 16;", "constexpr int QW = 8;")]
# a code of 2 or 3 bits from the buffer's top bit, with no memory access
_K4_NO_LOOKUP = [("const uint32_t e = tab[buf >> (64 - tb)];",
                  "const uint32_t e = 0x0302u ^ (uint32_t)(buf >> 63);")]
_K8_NO_LOOKUP = [("const uint32_t e = tab[hi >> (64 - mcl)];",
                  "const uint32_t e = 0x0302u ^ (uint32_t)(hi >> 63);")]
K4, K8 = "dense_decode.cu", "wide_decode.cu"
VARIANTS = {
    "baseline": {},
    "store_fold": {K4: [_K4_FOLD, _K4_FOLD_STAGED],
                   K8: [_K8_FOLD, _K8_FOLD_STAGED]},
    "src_l1": {K4: [_K4_L1], K8: [_K8_L1]},
    "fold_l1": {K4: [_K4_FOLD + _K4_L1], K8: [_K8_FOLD + _K8_L1]},
    "no_rank": {K8: [_K8_NO_RANK]},
    "lines128": {K8: [_K8_LINES]},
    "one_cta": {K8: [_K8_ONE_CTA]},
    "ring8": {K4: [_K4_RING8]},
    "no_lookup": {K4: [_K4_NO_LOOKUP], K8: [_K8_NO_LOOKUP]},
}
# variants that compute the same result, and are held to the input
EXACT = {"baseline", "lines128", "one_cta", "ring8"}


def patch_tree(tree: str, dst: str, variant: str) -> dict:
    """Copy tree's package to dst and apply the variant; returns which
    kernel sources the variant applies to."""
    return ablation.patch_tree(tree, dst, VARIANTS[variant])


def child(pkg_root: str, data_dir: str, check: bool) -> dict:
    """Build the package copy at pkg_root and time K4 and K8 on each size."""
    sys.path.insert(0, pkg_root)
    import torch
    from huffman_tpu_torch import api, wide
    from huffman_tpu_torch.ops.cuda import _build
    from huffman_tpu_torch.ops.cuda import dense_decode as k_decode
    from huffman_tpu_torch.ops.cuda import wide_decode as k_wdec
    from huffman_tpu_torch.ops.decode import table_entries
    from huffman_tpu_torch.ops.scan import exclusive_bit_offsets
    if not _build.PKG.startswith(pkg_root):
        raise RuntimeError(f"imported {_build.PKG}, not the copy")
    log = _build.build()
    dev = torch.device("cuda")

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    lines = log.splitlines()
    res = {"ptxas": [" ".join(x.strip() for x in lines[i: i + 3])
                     for i, ln in enumerate(lines)
                     if "Compiling entry" in ln and "decode" in ln]}
    for name, n in ablation.SIZES.items():
        data = np.load(os.path.join(data_dir, f"{name}.npy"))
        enc = api.encode(data, device="cuda")
        bb = enc.config.block_bytes
        nb = len(enc.block_bits)
        offs = exclusive_bit_offsets(torch.from_numpy(enc.block_bits).to(dev))
        starts = np.arange(nb, dtype=np.int64) * bb
        valid = torch.from_numpy(np.clip(n - starts, 0, bb)
                                 .astype(np.int32)).to(dev)
        tb = max(enc.codebook.max_len, 1)
        table = torch.from_numpy(table_entries(enc.codebook, tb)).to(dev)
        stream = torch.from_numpy(enc.stream_words.view(np.int32)).to(dev)

        def k4():
            return k_decode.decode_blocks(stream, offs.word_base,
                                          offs.bit_shift, valid, table, tb,
                                          bb)
        wenc = wide.encode_wide(data, device="cuda")
        tw = wenc.tile_words.astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(2 * tw)])[:-1]
        nt = len(tw)
        mcl = wide.reader_mcl(wenc.codebook)
        w_args = [torch.from_numpy(a).to(dev) for a in (
            wenc.payload_words.view(np.int32), starts, tw.astype(np.int32),
            np.ascontiguousarray(wenc.bases, np.int32),
            wide.tile_bytes(n, 0, nt), table_entries(wenc.codebook, mcl))]

        def k8():
            return k_wdec.decode_tiles(*w_args, mcl)
        if check:
            for kernel, fn in (("K4", k4), ("K8", k8)):
                if not np.array_equal(fn().reshape(-1)[:n].cpu().numpy(),
                                      data):
                    raise RuntimeError(f"{kernel} output != input at {name}")
        res[name] = {"dense_decode_ms": ms(k4, ablation.REPS[name]),
                     "wide_decode_ms": ms(k8, ablation.REPS[name]),
                     "stream_bytes": int(enc.stream_words.nbytes),
                     "payload_bytes": int(wenc.payload_words.nbytes)}
        del stream, w_args, offs, valid
        torch.cuda.empty_cache()
    return res



if __name__ == "__main__":
    sys.exit(ablation.main(__file__, __doc__, VARIANTS, EXACT, child))
