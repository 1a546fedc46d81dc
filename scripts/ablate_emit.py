#!/usr/bin/env python3
"""Ablations of the wide schedule and K7 emit (csrc/wide_emit.cu) on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/ablate_emit.py --tree DIR [--variants a,b] \\
        [--data DIR2] [--out FILE]

DIR is a checkout of this repository (default: the repository itself),
so the same script ablates an older commit's kernels from a `git archive`
of it.  For each variant below it copies DIR/huffman_tpu_torch into a
temporary directory, rewrites csrc/wide_emit.cu there by exact text
substitution (a variant whose text is not found is reported as not
applicable), builds that copy in a child process, and times the schedule
kernel alone and the schedule with the emit kernel through their wrappers,
with CUDA events, at 64 MiB and 1 GiB of the main path's profile
(testdata.entropy_stream, 32 symbols, H = 2.2066; --data keeps the inputs
between runs, and shares them with scripts/ablate_encoders.py).  The calls
are captured in a CUDA graph and replayed (chip_smoke.graph_ms): the
wrappers' host overhead is longer than these kernels.  K5's
streams and l2 are made once per size by the copy's own K5.  The variants
in EXACT compute the same result and are held to the plain versions
exactly, tile slices of 64 MiB at a time; every other variant computes
something else on purpose, and its time says what the removed work cost.
Nothing of the repository's own build or sources changes.

Variants, and the TPU probe under experiments/ that each stands for:
  baseline   the kernels as they are.
  nosel      the stream loads removed: a pull stores a fixed word pair made
             from its place.  probe_emit.py:25 main, its "nosel" (the select
             tournament replaced by a fixed word pair).
  noroute    the CTA-wide rank removed: a pulling thread stores at the
             round's base plus its own index, with no barrier.
             probe_emit.py:25 main, its "noroute" (_row_compact_place2
             replaced by a raw OR).
  neither    both: the round loop, the pull test and the stores alone.
             probe_emit.py:25 main, its "neither" (the loop and flush
             floor).
  relayout   a K6 kernel first turns K5's rows into word-major planes per
             tile through shared memory, and the emit reads word w of
             substream k at plane w, lane k; relayout and emit are timed
             together (exact).  probe_relayout.py:24 main (the XLA
             transpose against a Pallas in-register transpose).
  handoff    an identity device copy of what the schedule hands the emit
             (the pull masks; l2 in the lock-step design) between the two,
             and the emit reads the copy (exact): what a kernel-to-kernel
             handoff costs.  probe_relayout.py:129 pos_handoff.
  scan_only  new design only: the emit copies the words to pull and scans
             the rounds, and places nothing.
A variant's alternatives are tried in order, the design of the pull masks
first, then the lock-step design it replaced (one CTA-wide count a round);
the first whose every old text is in the tree's source is applied.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ablation  # noqa: E402  (the shared runner, beside this script)

CHECK_TILES = 256               # the plain versions run on slices this big
CU = "wide_emit.cu"

# --- the emit's signature and launch, in each design ---
_N_HEAD = ("                            const void* offsets, int nt, "
           "void* payload,\n                            void* stream) {\n")
_N_ARGS = "      (const uint32_t*)streams, slot, (const uint64_t*)masks,\n"
_P_HEAD = ("                            int nt, int mcl, void* payload, "
           "void* stream) {\n")
_P_ARGS = "      (const uint32_t*)streams, slot, (const uint8_t*)l2,\n"
_NS_END = "}  // namespace\n"
_RELAYOUT_KERNEL = """\
// K6: tile t's (WIDE_N_SUB, slot) stream rows -> (slot, WIDE_N_SUB) word
// planes, 32 x 32 blocks through shared memory.
__global__ void __launch_bounds__(1024)
relayout_kernel(const uint32_t* __restrict__ in, int slot,
                uint32_t* __restrict__ out) {
  __shared__ uint32_t s[32][33];
  const long long base = (long long)blockIdx.x * WIDE_N_SUB * slot;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int k0 = 0; k0 < WIDE_N_SUB; k0 += 32)
    for (int w0 = 0; w0 < slot; w0 += 32) {
      if (w0 + tx < slot)
        s[ty][tx] = in[base + (long long)(k0 + ty) * slot + w0 + tx];
      __syncthreads();
      if (w0 + ty < slot)
        out[base + (long long)(w0 + ty) * WIDE_N_SUB + k0 + tx] = s[tx][ty];
      __syncthreads();
    }
}

"""
_PLANES = """\
  static uint32_t* planes = nullptr;
  static long long planes_n = 0;
  const long long n = (long long)nt * WIDE_N_SUB * slot;
  if (planes_n < n) {
    cudaFree(planes);
    if (cudaMalloc(&planes, n * 4) != cudaSuccess) return 2;
    planes_n = n;
  }
  relayout_kernel<<<nt, 1024, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)streams, slot, planes);
"""
# an identity device copy of `what`, `size` bytes a substream
_COPY = """\
  static char* copy = nullptr;
  static long long copy_n = 0;
  const long long n = (long long)nt * WIDE_N_SUB * {size};
  if (copy_n < n) {{
    cudaFree(copy);
    if (cudaMalloc(&copy, n) != cudaSuccess) return 2;
    copy_n = n;
  }}
  cudaMemcpyAsync(copy, {what}, n, cudaMemcpyDeviceToDevice,
                  (cudaStream_t)stream);
"""
_N_HANDOFF = [(_N_HEAD, _N_HEAD + _COPY.format(size=8, what="masks")),
              (_N_ARGS, _N_ARGS.replace("masks,", "copy,"))]
_P_HANDOFF = [(_P_HEAD, _P_HEAD + _COPY.format(size="WIDE_ITEMS",
                                               what="l2")),
              (_P_ARGS, _P_ARGS.replace("l2,", "copy,"))]
_WORD_PAIR = ("""  const int w = 2 * i;
  if (!(slot & 1))
    return w < slot ? *reinterpret_cast<const uint2*>(src + w)
                    : make_uint2(0u, 0u);
  return make_uint2(w < slot ? src[w] : 0u, w + 1 < slot ? src[w + 1] : 0u);
""", """  const long long w = 2 * i;
  return make_uint2(w < slot ? src[w * WIDE_N_SUB] : 0u,
                    w + 1 < slot ? src[(w + 1) * WIDE_N_SUB] : 0u);
""")

# --- alternatives for the pull-mask design ---
_N_COPY = ("  stage_rows(m, streams + (row - (k & 31)) * slot, slot,\n"
           "             staged + (k & ~31) * ROW_PITCH);\n")
_N_PAIR = ("      const uint2 v = i < in_stage\n"
           "                          ? *reinterpret_cast<const uint2*>(staged"
           " + 2 * i)\n"
           "                          : word_pair(src, slot, i);\n")
_N_NOSEL = [(_N_COPY, ""),
            (_N_PAIR, "      const uint2 v = make_uint2((uint32_t)i, "
                      "(uint32_t)j);\n")]
_N_SCAN = "  scan_rounds(m, s, bases + t * WIDE_ROUNDS);\n"
_N_PLACE = ("  place_pulls(m, s, staged + k * ROW_PITCH, streams + row * "
            "slot, slot, p0,\n              p0 + tw, tw);\n")
_N_OWN_SLOT = """\
  const int32_t* base = bases + t * WIDE_ROUNDS;
  for (int j = 0, i = 0; j < WIDE_ROUNDS; ++j) {
    if (!((m >> j) & 1u)) continue;
    const int pos = base[j] + k;
    if (pos < tw) {
      const uint2 v = i < staged_pairs(slot)
          ? *reinterpret_cast<const uint2*>(staged + k * ROW_PITCH + 2 * i)
          : word_pair(streams + row * slot, slot, i);
      p0[pos] = v.x;
      p0[tw + pos] = v.y;
    }
    ++i;
  }
"""
_N_NOROUTE = [(_N_SCAN, ""), (_N_PLACE, _N_OWN_SLOT)]
_N_NEITHER = [(_N_SCAN, ""), (_N_COPY, ""), (_N_PLACE, _N_OWN_SLOT.replace(
    """      const uint2 v = i < staged_pairs(slot)
          ? *reinterpret_cast<const uint2*>(staged + k * ROW_PITCH + 2 * i)
          : word_pair(streams + row * slot, slot, i);
""", "      const uint2 v = make_uint2((uint32_t)i, (uint32_t)j);\n"))]
_N_RELAYOUT = [
    _WORD_PAIR,
    ("""      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\\n" ::"r"(d),
                   "l"(rows + (long long)r * slot + 2 * pp)
                   : "memory");
""", """      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(d),
                   "l"(rows + r + (long long)(2 * pp) * WIDE_N_SUB)
                   : "memory");
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(d + 4),
                   "l"(rows + r + (long long)(2 * pp + 1) * WIDE_N_SUB)
                   : "memory");
"""),
    (_N_COPY, _N_COPY.replace("streams + (row - (k & 31)) * slot",
                              "streams + (long long)t * WIDE_N_SUB * slot + "
                              "(k & ~31)")),
    (_N_PLACE, _N_PLACE.replace("streams + row * slot", "streams + (long "
                                "long)t * WIDE_N_SUB * slot + k")),
    (_NS_END, _RELAYOUT_KERNEL + _NS_END), (_N_HEAD, _N_HEAD + _PLANES),
    (_N_ARGS, _N_ARGS.replace("(const uint32_t*)streams", "planes"))]

# --- alternatives for the lock-step design ---
_P_STORE = ("      p0[pos] = wcur < slot ? src[wcur] : 0u;\n"
            "      p1[pos] = wcur + 1 < slot ? src[wcur + 1] : 0u;\n")
_P_NOSEL = [(_P_STORE, "      p0[pos] = (uint32_t)wcur ^ (uint32_t)k;\n"
             "      p1[pos] = (uint32_t)pos;\n")]
_P_NOROUTE = [
    ("    const uint32_t rank = cta_exclusive_count(pull, s_scan, &total);\n",
     "    const uint32_t rank = (uint32_t)k;\n"),
    ("    uint32_t total;\n", ""),
    ("  if (k < WIDE_ROUNDS) s_base[k] = bases[t * WIDE_ROUNDS + k];\n",
     "  if (k < WIDE_ROUNDS) s_base[k] = bases[t * WIDE_ROUNDS + k];\n"
     "  __syncthreads();\n")]
_P_RELAYOUT = [
    ("  const uint32_t* src = streams + row * slot;\n",
     "  const uint32_t* src = streams + (long long)t * WIDE_N_SUB * slot + k;"
     "\n"),
    (_P_STORE, "      p0[pos] = wcur < slot ? src[(long long)wcur * "
               "WIDE_N_SUB] : 0u;\n      p1[pos] = wcur + 1 < slot ? "
               "src[(long long)(wcur + 1) * WIDE_N_SUB] : 0u;\n"),
    (_NS_END, _RELAYOUT_KERNEL + _NS_END), (_P_HEAD, _P_HEAD + _PLANES),
    (_P_ARGS, _P_ARGS.replace("(const uint32_t*)streams", "planes"))]

# variant -> {kernel source: [alternative, ...]}: an alternative is a list
# of (old text, new text) pairs
VARIANTS = {
    "baseline": {},
    "nosel": {CU: [_N_NOSEL, _P_NOSEL]},
    "noroute": {CU: [_N_NOROUTE, _P_NOROUTE]},
    "neither": {CU: [_N_NEITHER, _P_NOSEL + _P_NOROUTE]},
    "relayout": {CU: [_N_RELAYOUT, _P_RELAYOUT]},
    "handoff": {CU: [_N_HANDOFF, _P_HANDOFF]},
    "scan_only": {CU: [[(_N_PLACE, "")]]},
}
# variants that compute the same result, and are held to the plain versions
EXACT = {"baseline", "relayout", "handoff"}
# the TPU probes (experiments/ file:line) that each variant stands for
STANDS_FOR = {
    "baseline": [],
    "nosel": ["probe_emit.py:25"],
    "noroute": ["probe_emit.py:25"],
    "neither": ["probe_emit.py:25"],
    "relayout": ["probe_relayout.py:24"],
    "handoff": ["probe_relayout.py:129"],
    "scan_only": [],
}


def patch_tree(tree: str, dst: str, variant: str) -> dict:
    """Copy tree's package to dst and apply the variant; returns which
    kernel sources the variant applies to."""
    return ablation.patch_tree(tree, dst, VARIANTS[variant])


def child(pkg_root: str, data_dir: str, check: bool) -> dict:
    """Build the package copy at pkg_root and time the schedule and the
    schedule with K7 on each size."""
    sys.path.insert(0, pkg_root)
    sys.path.append(ablation.REPO)      # chip_smoke: timer, bound formulas
    import torch
    from chip_smoke import bound, graph_ms, wide_work
    from huffman_tpu_torch import api, wide
    from huffman_tpu_torch.config import CodecConfig
    from huffman_tpu_torch.ops import wide as p_wide
    from huffman_tpu_torch.ops.cuda import _build
    from huffman_tpu_torch.ops.cuda import wide_emit as k_emit
    from huffman_tpu_torch.ops.cuda import wide_encode as k_sub
    if not _build.PKG.startswith(pkg_root):
        raise RuntimeError(f"imported {_build.PKG}, not the copy")
    log = _build.build()
    dev = torch.device("cuda")
    lines = log.splitlines()
    res = {"ptxas": [" ".join(x.strip() for x in lines[i: i + 4])
                     for i, ln in enumerate(lines)
                     if "Compiling entry" in ln and "kernel" in ln
                     and ("wide_" in ln or "relayout" in ln)]}
    for name in ablation.SIZES:
        data = np.load(os.path.join(data_dir, f"{name}.npy"))
        rows, valid = wide.device_substreams(data, dev)
        cb = api.build_codebook(data, CodecConfig(), dev)
        mcl = wide.reader_mcl(cb)
        slot = wide.slot_words(mcl)
        codes, lengths = api.codebook_tensors(cb, dev)
        streams, _, l2 = k_sub.sub_encode(rows, codes, lengths, valid, slot)
        del rows, valid
        nt = l2.shape[0] // p_wide.N_SUB
        tb = torch.from_numpy(wide.tile_bytes(data.size, 0, nt)).to(dev)
        bases, tw = k_emit.schedule_counts(l2, tb, mcl)[:2]
        offs, n_words = wide.payload_offsets(tw)

        def emit(mod, sched, rows, tiles, offsets, words):
            """mod's emit on rows/tiles of sched's schedule; the lock-step
            design's emit takes l2 where this one takes masks."""
            if len(sched) == 3:
                return mod.emit_planes(streams[rows], sched[2], *sched[:2],
                                       offsets, words)
            return mod.emit_planes(streams[rows], l2[rows], tb[tiles],
                                   *sched, offsets, mcl, words)

        def sched():
            return k_emit.schedule_counts(l2, tb, mcl)

        def sched_emit():
            return emit(k_emit, sched(), slice(None), slice(None), offs,
                        n_words)
        payload = sched_emit()
        if check:
            for t0 in range(0, nt, CHECK_TILES):
                t1 = min(nt, t0 + CHECK_TILES)
                rows = slice(t0 * p_wide.N_SUB, t1 * p_wide.N_SUB)
                ps = p_wide.schedule_counts(l2[rows], tb[t0:t1], mcl)
                w0 = int(offs[t0])
                w1 = int(offs[t1]) if t1 < nt else n_words
                pp = emit(p_wide, ps, rows, slice(t0, t1),
                          offs[t0:t1] - w0, w1 - w0)
                if not (torch.equal(bases[t0:t1], ps[0])
                        and torch.equal(tw[t0:t1], ps[1])
                        and torch.equal(payload[w0:w1], pp)):
                    raise RuntimeError(f"{name}: tiles [{t0}, {t1}) differ "
                                       "from the plain versions")
        work = wide_work(nt, slot, n_words, mcl)
        res[name] = {"schedule_ms": graph_ms(sched, ablation.REPS[name]),
                     "emit_ms": graph_ms(sched_emit, ablation.REPS[name]),
                     "emit_bytes": work["wide_emit"][0],
                     "emit_bound_ms": bound(work["wide_emit"])[0],
                     "tiles": nt, "mcl": mcl, "payload_words": n_words,
                     "exact_checked": check}
        del streams, l2, payload, bases, tw, offs
        torch.cuda.empty_cache()
    return res



if __name__ == "__main__":
    sys.exit(ablation.main(__file__, __doc__, VARIANTS, EXACT, child))
