#!/usr/bin/env python3
"""Ablations of the two encode kernels (K1 dense, K5 wide) on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/ablate_encoders.py --tree DIR [--variants a,b] \\
        [--data DIR2] [--out FILE]

DIR is a checkout of this repository (default: the repository itself),
so the same script ablates an older commit's kernels from a `git archive`
of it.  For each variant below it copies DIR/huffman_tpu_torch into a
temporary directory, rewrites the kernel sources there by exact text
substitution (a variant whose text is not found in that tree's kernel is
reported as not applicable), builds that copy in a child process, and
times K1 and K5 through their wrappers with CUDA events at 64 MiB and
1 GiB of the main path's profile (testdata.entropy_stream, 32 symbols,
H = 2.2066; --data keeps the inputs between runs).  The variants in EXACT
compute the same result and are held to the plain versions exactly, in
slices of 64 MiB; every other variant computes something else on purpose,
and its time says what the removed work cost.  Nothing of the
repository's own build or sources changes.

Variants, and the TPU probe under experiments/ that each stands for:
  baseline       the kernels as they are.
  lookup_only    the input loads and the 256-entry table lookups alone,
                 XOR-folded into one store per thread: no scan, placement
                 or row store.  Stands for probe_gather.py:42 k_lane and
                 :71 tab256_lookup, and profile_levels.py:25's LUT-only
                 kernel.
  no_valid_mask  the per-byte `live` masking removed (exact here: every
                 row of these inputs is full).  probe_head_ablate.py:30
                 (its l0nv).
  stop_scan      lookups and the row scan; the placement is removed, so
                 the zeroed staging is stored.  probe_dense_ablate.py:30
                 and profile_levels.py:25 (their stop levels).
  no_atomic      placement by plain shared-memory ORs in place of atomicOr
                 (racy: time only).  probe_merge_ops.py:30 (op classes
                 removed).
  store_fold     the row store folded into one word per thread.
                 probe_finish32.py:22 (the finish pass).
  acc_path       the one-code-at-a-time placement forced for every thread
                 (exact).  probe_quad16.py:165 timeit (fused against
                 chained placement).
  ring2          warp design only: the input ring one group ahead in
                 place of two (exact).
  ctas12         warp design only: registers capped for 12 CTAs (48 warps)
                 an SM (exact).
  op_costs       not a rewrite: scripts/op_costs.cu times one lookup, one
                 shuffle step, one shared atomicOr, one barrier and one
                 multiply-add in a dependency chain.  probe_ops.py:14
                 probe and probe_op_costs.py:13 main.
A variant's alternatives are tried in order, the warp design of the row
encoder (PR 5) first, then the CTA-per-row design (PR 1-4); the first
whose every old text is in the tree's sources is applied.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ablation  # noqa: E402  (the shared runner, beside this script)

CHECK_BYTES = 64 << 20          # the plain versions run on slices this big
OP_COSTS = "op_costs"
OP_CHAIN = 1 << 16              # operations per calibration chain
CU = "common.cuh"

# --- alternatives for the CTA-per-row design (encode_rows_kernel, PR 1-4) ---
_C_LOOP = "  for (long long b = blockIdx.x; b < nb; b += gridDim.x) {\n"
_C_FOLD_DECL = (_C_LOOP, "  uint32_t fold = 0;\n" + _C_LOOP)
_C_ROW_END = ("    __syncthreads();    // s_out and s_warp are reused by the "
              "next row\n  }\n}\n")
_C_FOLD_END = (_C_ROW_END, _C_ROW_END[:-2]
               + "  out[(long long)blockIdx.x * blockDim.x + t] = fold;\n}\n")
_C_ZERO = "    for (int i = t; i < cap; i += blockDim.x) s_out[i] = 0u;\n"
_C_ITEM = ("    if (ITEM_BITS && t < bw) item_bits[b * bw + t] = "
           "(uint8_t)total;\n")
_C_FUSED = "    if (total > 0 && total <= 64) {"
_C_CHAINED = "    } else if (total > 64) {"
_C_LOOKUP_ONLY = [
    _C_FOLD_DECL, (_C_ZERO, ""),
    (_C_ITEM, "    fold ^= total ^ cds[0] ^ cds[1] ^ cds[2] ^ cds[3] ^ "
              "(uint32_t)miss;\n    continue;\n"),
    _C_FOLD_END]
_C_NO_VALID = [("      const bool live = t < bw && 4 * t + k < nvalid;",
                "      const bool live = t < bw;")]
_C_STOP_SCAN = [(_C_FUSED, "    if (false) {"),
                (_C_CHAINED, "    } else if (false) {")]
_C_NO_ATOMIC = [
    ("  if (a && w < cap) atomicOr(&buf[w], a);",
     "  if (a && w < cap) buf[w] |= a;"),
    ("  if (b && w + 1 < cap) atomicOr(&buf[w + 1], b);",
     "  if (b && w + 1 < cap) buf[w + 1] |= b;"),
    ("  if (c && w + 2 < cap) atomicOr(&buf[w + 2], c);",
     "  if (c && w + 2 < cap) buf[w + 2] |= c;")]
_C_STORE_FOLD = [
    _C_FOLD_DECL,
    ("    for (int i = t; i < cap; i += blockDim.x) out[b * cap + i] = "
     "s_out[i];", "    for (int i = t; i < cap; i += blockDim.x) fold ^= "
                  "s_out[i];"),
    _C_FOLD_END]
_C_ACC_PATH = [(_C_FUSED, "    if (false) {"),
               (_C_CHAINED, "    } else if (total > 0) {")]

# --- alternatives for the warp design (encode_rows_warp, PR 5) ---
_W_LOOP = "  int slot = 0;\n  for (long long g = first; g < ng;\n"
_W_FOLD_DECL = (_W_LOOP, "  uint32_t fold = 0;\n" + _W_LOOP)
_W_ROW_END = "  }  // rows\n}\n"
_W_FOLD_END = (_W_ROW_END, "  }  // rows\n  out[(long long)blockIdx.x * "
                           "blockDim.x + threadIdx.x] = fold;\n}\n")
_W_LOOKUP_ONLY = [
    _W_FOLD_DECL,
    ("    uint32_t lane_bits = 0;\n",
     "    for (int i = 0; i < 4 * W; ++i) fold ^= e[i];\n"
     "    fold ^= (uint32_t)miss;\n    __syncwarp();\n    continue;\n"
     "    uint32_t lane_bits = 0;\n"),
    _W_FOLD_END]
_W_NO_VALID = [("      const bool live = !MASK || first_byte + 4 * j + k < "
                "nvalid;", "      const bool live = true;")]
_W_STOP_SCAN = [("    place_codes<W>(stage + r * cap, cap, incl - lane_bits, "
                 "e, ib);\n", "")]
_W_NO_ATOMIC = [("  atomicOr(p, v);\n", "  *p |= v;\n")]
_W_STORE_FOLD = [
    _W_FOLD_DECL,
    ("        reinterpret_cast<uint4*>(orow)[c] = v;",
     "        fold ^= v.x ^ v.y ^ v.z ^ v.w;"),
    ("        orow[i] = v;", "        fold ^= v;"),
    _W_FOLD_END]
_W_ACC_PATH = [("    if (ib[j] <= 32) {                     // the item's "
                "four codes fused", "    if (false) {")]
_W_RING2 = [("constexpr int ENC_RING = 3;", "constexpr int ENC_RING = 2;")]
_W_CTAS12 = [("__global__ void __launch_bounds__(32 * ENC_WARPS)\n",
              "__global__ void __launch_bounds__(32 * ENC_WARPS, 12)\n")]

# variant -> {kernel source: [alternative, ...]}: an alternative is a list
# of (old text, new text) pairs
VARIANTS = {
    "baseline": {},
    "lookup_only": {CU: [_W_LOOKUP_ONLY, _C_LOOKUP_ONLY]},
    "no_valid_mask": {CU: [_W_NO_VALID, _C_NO_VALID]},
    "stop_scan": {CU: [_W_STOP_SCAN, _C_STOP_SCAN]},
    "no_atomic": {CU: [_W_NO_ATOMIC, _C_NO_ATOMIC]},
    "store_fold": {CU: [_W_STORE_FOLD, _C_STORE_FOLD]},
    "acc_path": {CU: [_W_ACC_PATH, _C_ACC_PATH]},
    "ring2": {CU: [_W_RING2]},
    "ctas12": {CU: [_W_CTAS12]},
}
# variants that compute the same result, and are held to the plain versions
EXACT = {"baseline", "no_valid_mask", "acc_path", "ring2", "ctas12"}
# the TPU probes (experiments/ file:line) that each variant stands for
STANDS_FOR = {
    "baseline": [],
    "lookup_only": ["probe_gather.py:42", "probe_gather.py:71",
                    "profile_levels.py:25"],
    "no_valid_mask": ["probe_head_ablate.py:30"],
    "stop_scan": ["probe_dense_ablate.py:30", "profile_levels.py:25"],
    "no_atomic": ["probe_merge_ops.py:30"],
    "store_fold": ["probe_finish32.py:22"],
    "acc_path": ["probe_quad16.py:165"],
    "ring2": [],
    "ctas12": [],
    OP_COSTS: ["probe_ops.py:14", "probe_op_costs.py:13"],
}
OPS = ["lookup", "shuffle", "atomic_or", "barrier", "imad"]


def patch_tree(tree: str, dst: str, variant: str) -> dict:
    """Copy tree's package to dst and apply the variant; returns which
    kernel sources the variant applies to."""
    return ablation.patch_tree(tree, dst, VARIANTS[variant])


def child(pkg_root: str, data_dir: str, check: bool) -> dict:
    """Build the package copy at pkg_root and time K1 and K5 on each size."""
    sys.path.insert(0, pkg_root)
    sys.path.append(ablation.REPO)      # chip_smoke: work, bound formulas
    import torch
    from chip_smoke import bound, cuda_ms, dense_work, wide_work
    from huffman_tpu_torch import api, wide
    from huffman_tpu_torch.config import CodecConfig
    from huffman_tpu_torch.ops import encode as p_encode
    from huffman_tpu_torch.ops import wide as p_wide
    from huffman_tpu_torch.ops.cuda import _build
    from huffman_tpu_torch.ops.cuda import encode as k_encode
    from huffman_tpu_torch.ops.cuda import wide_encode as k_sub
    if not _build.PKG.startswith(pkg_root):
        raise RuntimeError(f"imported {_build.PKG}, not the copy")
    log = _build.build()
    dev = torch.device("cuda")
    lines = log.splitlines()
    res = {"ptxas": [" ".join(x.strip() for x in lines[i: i + 4])
                     for i, ln in enumerate(lines)
                     if "Compiling entry" in ln and "encode_rows" in ln]}
    cfg = CodecConfig()

    def same(kernel_out, plain_fn, rows: int) -> bool:
        """kernel_out (a tuple of row-major tensors) equals plain_fn(i, j)
        on every slice [i, j) of `rows` rows."""
        n = kernel_out[0].shape[0]
        for i in range(0, n, rows):
            want = plain_fn(i, min(n, i + rows))
            if not all(torch.equal(k[i: i + rows], p)
                       for k, p in zip(kernel_out, want)):
                return False
        return True

    for name in ablation.SIZES:
        data = np.load(os.path.join(data_dir, f"{name}.npy"))
        blocks, valid = api.device_blocks(data, cfg, dev)
        cb = api.build_codebook(data, cfg, dev)
        codes, lengths = api.codebook_tensors(cb, dev)
        cap = cfg.capacity_words
        rows, rvalid = wide.device_substreams(data, dev)
        mcl = wide.reader_mcl(cb)
        slot = wide.slot_words(mcl)

        def k1():
            return k_encode.encode_blocks(blocks, codes, lengths, valid, cap)

        def k5():
            return k_sub.sub_encode(rows, codes, lengths, rvalid, slot)
        streams, bits = k1()
        if check:
            ok1 = same((streams, bits), lambda i, j: p_encode.encode_blocks(
                blocks[i:j], codes, lengths, valid[i:j], cap),
                CHECK_BYTES // cfg.block_bytes)
            ok5 = same(k5(), lambda i, j: p_wide.sub_encode(
                rows[i:j], codes, lengths, rvalid[i:j], slot),
                CHECK_BYTES // p_wide.SUB_BYTES)
            if not (ok1 and ok5):
                raise RuntimeError(f"K1 equal {ok1}, K5 equal {ok5} at {name}")
        nb = blocks.shape[0]
        w1 = dense_work(nb, cfg.block_bytes, cap, bits, 0, 1)["encode"]
        w5 = wide_work(rows.shape[0] // 1024, slot, 0, mcl)["wide_sub_encode"]
        res[name] = {"encode_ms": cuda_ms(k1, ablation.REPS[name]),
                     "wide_sub_encode_ms": cuda_ms(k5, ablation.REPS[name]),
                     "encode_bytes": w1[0], "encode_bound_ms": bound(w1)[0],
                     "wide_sub_encode_bytes": w5[0],
                     "wide_sub_encode_bound_ms": bound(w5)[0],
                     "exact_checked": check}
        del blocks, valid, rows, rvalid, streams, bits
        torch.cuda.empty_cache()
    return res


def op_costs(build_dir: str, data_dir: str) -> dict:
    """Build scripts/op_costs.cu and return ns per operation of each kind
    (it reads no input from data_dir)."""
    from huffman_tpu_torch.ops.cuda import _build
    lib_path = os.path.join(build_dir, "libopcosts.so")
    r = subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,"
                        "code=sm_90a", "-O3", "-shared", "-Xcompiler",
                        "-fPIC", "-o", lib_path,
                        os.path.join(ablation.REPO, "scripts", "op_costs.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(lib_path)
    lib.op_cost_ns.argtypes = [ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_float)]
    lib.op_cost_ns.restype = ctypes.c_int
    out = {}
    for i, op in enumerate(OPS):
        ns = ctypes.c_float()
        err = lib.op_cost_ns(i, OP_CHAIN, ctypes.byref(ns))
        if err:
            raise RuntimeError(f"op_costs {op}: CUDA error {err}")
        out[f"{op}_ns"] = ns.value
    return out



if __name__ == "__main__":
    sys.exit(ablation.main(__file__, __doc__, VARIANTS, EXACT, child,
                           {OP_COSTS: op_costs}))
