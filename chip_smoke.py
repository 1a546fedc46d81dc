#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (huffman_tpu_torch) on one GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device  - nvidia-smi's name and power limit, torch and CUDA versions.
  2. build   - nvcc builds every kernel of csrc/ for sm_90a; seconds taken
               and the -Xptxas -v register/spill lines.
  3. kernels - each dense kernel (K1 encode, pack, K4 decode) against its
               plain PyTorch version on the card, exactly: at the main path's
               shapes (64 MiB, 65536 blocks, K1 at the capacity api.encode
               keeps for that input) with times of both; the byte
               histogram against its plain version and torch.bincount on
               64 MiB of the main profile, uniform bytes and one repeated
               byte (times of all three, bincount's as library_ms), n_valid
               tails and start offsets of 1-15 bytes, 32-bit words, and
               5 GiB of one byte (a count past 2^32); the offset scan
               against its plain version (the torch.cumsum chain) on the
               64 MiB block bits from every start bit 0..31, blocks at
               capacity, 0, 1, 4095, 4097 and 1,048,583 counts (dense and
               wide), a misaligned start, a total past 2^32 bits and a
               word_base past 2^31, and a wide total past 2^62 - 1 that
               must raise (times of the kernel and the chain); then a uniform
               256-symbol input (every block exactly at capacity), a
               14-bit codebook, a 20-bit one
               (decode table in device memory), pack alone on blocks that
               spill into their neighbours (at 256 and 128 words), pack
               alone on tiny blocks
               (0..40 bits, runs of blocks sharing one word, some past
               their capacity) at start phases 0 and 13 with 16- and
               4-byte staging, small edge cases (64-byte blocks, and
               4096-byte ones: K1's two routes), and K4 over
               a span of blocks (api.decode_block_span) that starts at a
               nonzero bit shift and ends at the stream's last word.
               Blocks past 4 KiB: 8192 bytes (the CLI's --block-bytes
               8192) with 24-bit codes, and 262,144 bytes, whose 65,536
               words of capacity K1 cannot stage in shared memory; each
               through K1, pack and K4 against their plain versions (K4's
               at 262,144 bytes against the input alone: its plain version
               loops once a byte of the block), then api.encode equal to
               the golden encoder, api.decode and decode_range equal to
               the input.  Then the encode driver's branches through
               api.encode_traced, each against the golden encoder under its
               final codebook, decoded, with K1's launches counted: a
               sampled codebook that holds (64 MiB), a forced miss that
               rebuilds (8 MiB), a speculative capacity one block overflows
               (2 MiB), a chunked input with a partial last chunk and block
               (40 MiB + 37 bytes), and the ValueError of a given codebook
               on the chunked path.
  4. main    - the dense path at 1 GiB, 32 symbols at H = 2.2066: api.encode
               bit-exact against the C++ golden encoder, container dumps ->
               loads -> api.decode equal to the input, decode_range from a
               block at a nonzero bit shift equal to the input and to the
               golden decoder; launch counts read around that run; how the
               driver ran (sampled, rebuilt, capacities tried, chunks), the
               histogram's launches (the sample's and a rebuild's) and
               the final codebook's bits/byte beside the exact one's;
               end-to-end and kernel-only rates; K1's 1 GiB time at 128 and
               256 words, pack's and K4's beside their bounds, the
               offset scan's beside the torch.cumsum chain's (after
               holding it to the chain 20 times over on the 1 GiB bits),
               and the histogram's beside torch.bincount's.
               Then main_parent_flow (api.encode as the parent ran it,
               with no sampling, chunks or speculation, in turns with the
               change).
  4b. device - card-resident data: the payload swap and CRC-32 kernel
               (csrc/crc32.cu) against its plain version and zlib.crc32,
               both ways, at the 1 GiB stream's size (the main input's
               stream words) and on 0 to 1,048,579 words at a 4-byte
               offset, with its time beside its bound at that size and at a
               sixteenth of it; then the main input as a CUDA tensor through
               api.encode_traced -> container.dumps_device ->
               container.loads_device -> api.decode, its container equal
               to phase 4's host container byte for byte, its output equal
               to the input on the card, one K1 pass (the codebook chosen
               from the sample's and the exact histogram before K1), the
               launches of each kernel and
               the bytes that crossed (under 1% of the input), and each
               stage's wall.
  4c. planes - bf16 weights DFloat11's way: the split and merge kernels
               (csrc/planes.cu) against their plain versions on 0 to
               2^20 + 3 words at word offsets 0-8 (views off a 16-byte
               address), on every bf16 bit pattern, and with planes at
               byte offsets 1-4 (views into a container), with their
               1 GB times beside their bound (4 bytes a word); the CRC
               pass without the swap against zlib, copying or only
               reading, from a start value or none; then one Nemotron-H-47B
               MLP block (503,316,480 bf16 weights drawn as the benchmark's
               traffic draws them) through api.encode_traced ->
               container.dumps_device -> container.loads_device ->
               api.decode, its version 4 container equal to the plain
               reference's sections (bench_torch/reference/df11.py), its
               output equal to the input bit for bit, each kernel's
               launches, the bytes that crossed and each stage's wall.
  5. wide_kernels - each wide kernel (K5 substream encode, the schedule and
               K7 emit, K8 decode) against its plain version, exactly: at
               64 MiB (256 tiles) of the main profile with CUDA event times;
               uniform 256 symbols (8-bit codes); a 12-bit codebook whose
               longest codes fill substreams (96 words, the reader's buffer
               at 111 bits); a narrow book (mcl <= 4); K5 alone on 1021
               rows; partial, sub-tile and non-power-of-two tile counts.
               Small cases also against the format's specification, tile
               by tile.
  6. wide_main - the wide path on the same 1 GiB: wide.encode_wide ->
               container dumps_wide -> loads_wide -> wide.decode_wide equal
               to the input, decode_wide_range across tiles; launch counts
               read around that run (one histogram, one offset scan);
               the payload offsets against their plain version; the
               first 16 tiles and the last one
               equal to the specification's encoder; end-to-end and
               kernel-only rates, K5's, the schedule with K7's and K8's
               1 GiB times beside their bounds, and bits per byte beside
               the dense stream's.
  7. sharded - parallel.ShardedCodec over four shards of cuda:0 on the same
               1 GiB: its codebook the exact one, the dense encode equal to
               api.encode's stream and container under that codebook, the
               wide encode equal to phase 6's container, both
               decodes equal to the input; launch counts read around that run
               (every kernel at least once per shard, the histogram and
               the offset scan once a shard in each encode); walls beside the
               single-device walls of phases 4 and 6.  Four shards on one
               card show what sharding costs, not how it scales.
  8. multiprocess - two copies of this script (--worker RANK 2 PORT) join one
               gloo process group with two shards of cuda:0 each, a mesh of
               four: on 64 MiB of the same profile each checks the dense
               codebook against the exact one, the dense stream against
               api.encode's under it, the wide container against the
               single-device one and both roundtrips, and prints an OK
               line; the run fails if a
               worker fails, times out or prints none.
Then the kernels line (each kernel's launches on the main paths, its
error against its plain version, its time (the device time of launches
captured in a CUDA graph: graph_ms), the plain version's, and its bound:
the larger of the bytes it must move at 3.35 TB/s and its operations at
67 T/s, all at the 64 MiB kernel shapes, K1 at the capacity api.encode
keeps there; torch.bincount's time as the histogram's library_ms, the
torch.cumsum chain's graph-replay time as the offset scan's), the card's
nvidia-smi line, and the result line.
Any mismatch raises and the script exits non-zero, as it does when no
CUDA device is available.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

MAIN_BYTES = 1 << 30            # the JAX README's spec size
KERNEL_BYTES = 64 << 20         # the kernel comparisons' size
WIDE_GOLDEN_TILES = 16          # leading tiles checked against the spec
SHARDS = 4                      # shards of cuda:0 in the sharded phase
MP_BYTES = 64 << 20             # the multiprocess phase's input
MP_WORKERS = 2                  # processes of the multiprocess phase
MP_TIMEOUT_S = 300              # each worker's time limit
MP_OK = "MULTIPROCESS-OK"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA's data sheet
OPS_PER_S = 67e12               # its non-tensor float32 rate, the peak of
                                # the scalar units that do the bit work


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over `reps` back-to-back calls, after one
    warm-up call, from CUDA events."""
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


def graph_ms(fn, reps: int) -> float:
    """Mean device time of fn over `reps` calls captured in one CUDA graph,
    from CUDA events around its replay, after one warm-up call: the
    kernels' own time, without the wrappers' host overhead, which can take
    longer than a short kernel (fn must not synchronize)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    del g
    return a.elapsed_time(b) / reps


def bound(work: tuple) -> tuple:
    """(bound_ms, bound_by) of a kernel's (bytes, operations): the least
    time the card could take, the larger of the bytes over HBM_BYTES_PER_S
    and the operations over OPS_PER_S."""
    nbytes, nops = work
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dense_work(nb: int, bb: int, cap: int, bits: torch.Tensor,
               n_words: int, table_bits: int) -> dict:
    """(bytes, operations) each dense kernel must do: K1 reads the blocks,
    valid counts and codebook and writes its capacity rows and bit counts,
    a lookup and a placement per byte; pack reads the rows' used words,
    bit counts and offsets and writes the stream, a shift and a merge per
    word; K4 reads the stream, offsets, valid counts and table and writes
    the blocks, a lookup and a shift per byte."""
    used = int(((bits.to(torch.int64) + 31) >> 5).sum())
    return {"encode": (nb * bb + 4 * nb + 2048 + nb * cap * 4 + 4 * nb,
                       2 * nb * bb),
            "pack": (4 * used + 16 * nb + 4 * n_words, 2 * used),
            "dense_decode": (4 * n_words + 16 * nb + 2 * (1 << table_bits)
                             + nb * bb, 2 * nb * bb)}


def wide_work(nt: int, slot: int, n_words: int, mcl: int) -> dict:
    """(bytes, operations) each wide kernel must do: K5 reads the
    substreams, valid counts and codebook and writes slot rows, bit counts
    and l2, a lookup and a placement per byte; the schedule reads l2 and
    writes the bases, plane lengths and pull masks, a pull test and a count
    per substream and round; K7, timed with the schedule, also reads the
    pulled words and writes the payload, a move per word (the pair leaves
    out the masks, which only pass from one kernel to the other); K8 reads
    the payload, tile tables and decode table and writes the tiles, a
    lookup and a shift per byte."""
    ns = nt * 1024
    sched = (ns * 64 + 4 * nt + nt * (256 + 4), 2 * ns * 64)
    return {"wide_sub_encode": (ns * 256 + 4 * ns + 2048 + ns * slot * 4
                                + 4 * ns + ns * 64, 2 * ns * 256),
            "wide_schedule": (sched[0] + 8 * ns, sched[1]),
            "wide_emit": (sched[0] + 8 * n_words + 8 * nt,
                          sched[1] + n_words),
            "wide_decode": (4 * n_words + nt * (8 + 4 + 256 + 4)
                            + 2 * (1 << mcl) + nt * 256 * 1024,
                            2 * nt * 256 * 1024)}


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> int:
    require(x.shape == y.shape, f"shapes {tuple(x.shape)} != {tuple(y.shape)}")
    if x.numel() == 0:
        return 0
    return int((x.to(torch.int64) - y.to(torch.int64)).abs().max())


class Stages:
    """The three kernels of the main path next to their plain versions,
    on device-resident inputs prepared once, so that a timed call is the
    wrapper's launch alone.  K1 runs at capacity `cap` words (default
    cfg.capacity_words)."""

    def __init__(self, data: np.ndarray, cfg, codebook=None,
                 cap: int | None = None):
        from huffman_tpu_torch import api
        from huffman_tpu_torch.ops.decode import table_entries
        self.cfg = cfg
        self.cap = cap or cfg.capacity_words
        self.blocks, self.valid = api.device_blocks(data, cfg,
                                                     torch.device("cuda"))
        self.cb = codebook or api.build_codebook(data, cfg, device="cuda")
        self.codes = torch.from_numpy(
            self.cb.codes.astype(np.uint32).view(np.int32)).cuda()
        self.lengths = torch.from_numpy(self.cb.lengths.astype(np.int32)).cuda()
        self.tb = max(self.cb.max_len, 1)
        self.table = torch.from_numpy(table_entries(self.cb, self.tb)).cuda()

    def encode(self, mod, cap: int | None = None):
        return mod.encode_blocks(self.blocks, self.codes, self.lengths,
                                 self.valid, cap or self.cap)

    @staticmethod
    def pack(mod, streams, bits, offs, n_words: int):
        return mod.pack_blocks(streams, bits, offs.word_base, offs.bit_shift,
                               n_words)

    def decode(self, mod, stream, offs):
        return mod.decode_blocks(stream, offs.word_base, offs.bit_shift,
                                 self.valid, self.table, self.tb,
                                 self.cfg.block_bytes)


def compare_kernels(name: str, data: np.ndarray, cfg, card: str, errs: dict,
                    codebook=None, reps: int = 0, plain_reps: int = 0,
                    times: dict | None = None,
                    plain_decode: bool = True, cap: int | None = None) -> dict:
    """Each kernel against its plain version on the same device inputs,
    K1 at `cap` words (default cfg.capacity_words); every output must
    match exactly, and the decoded bytes the input.  Without plain_decode,
    K4 is held to the input alone.  Returns the case's JSON record."""
    from huffman_tpu_torch.ops import decode as p_decode
    from huffman_tpu_torch.ops import encode as p_encode
    from huffman_tpu_torch.ops import pack as p_pack
    from huffman_tpu_torch.ops.cuda import dense_decode as k_decode
    from huffman_tpu_torch.ops.cuda import encode as k_encode
    from huffman_tpu_torch.ops.cuda import pack2 as k_pack
    from huffman_tpu_torch.ops.encode import BITS_MASK
    from huffman_tpu_torch.ops.scan import exclusive_bit_offsets

    st = Stages(data, cfg, codebook, cap)
    rec = {"phase": "kernels", "case": name, "bytes": int(data.size),
           "blocks": int(st.blocks.shape[0]),
           "capacity_words": st.cap,
           "max_code_len": int(st.cb.max_len)}
    s_k, b_k = st.encode(k_encode)
    s_p, b_p = st.encode(p_encode)
    e_enc = max(max_abs_err(s_k, s_p), max_abs_err(b_k, b_p))
    require(e_enc == 0, f"{name}: encode kernel != plain (max err {e_enc})")
    bits = b_k & BITS_MASK
    offs = exclusive_bit_offsets(bits)
    n_words = int(offs.total_words)
    w_k = st.pack(k_pack, s_k, bits, offs, n_words)
    w_p = st.pack(p_pack, s_k, bits, offs, n_words)
    e_pack = max_abs_err(w_k, w_p)
    require(e_pack == 0, f"{name}: pack kernel != plain (max err {e_pack})")
    o_k = st.decode(k_decode, w_k, offs)
    e_dec = (max_abs_err(o_k, st.decode(p_decode, w_k, offs)) if plain_decode
             else 0)
    require(e_dec == 0, f"{name}: decode kernel != plain (max err {e_dec})")
    back = o_k.reshape(-1)[: data.size].cpu().numpy()
    require(np.array_equal(back, data), f"{name}: decoded bytes != input")
    for k, e in (("encode", e_enc), ("pack", e_pack), ("dense_decode", e_dec)):
        errs[k] = max(errs.get(k, 0), e)
    rec["total_bits"] = int(offs.total_bits)
    rec["max_abs_err"] = {"encode": e_enc, "pack": e_pack,
                          "dense_decode": e_dec if plain_decode else None}
    if reps:
        t = {
            "encode": (graph_ms(lambda: st.encode(k_encode), reps),
                       cuda_ms(lambda: st.encode(p_encode), plain_reps)),
            "pack": (
                graph_ms(lambda: st.pack(k_pack, s_k, bits, offs, n_words),
                         reps),
                cuda_ms(lambda: st.pack(p_pack, s_k, bits, offs, n_words),
                        plain_reps)),
            "dense_decode": (
                graph_ms(lambda: st.decode(k_decode, w_k, offs), reps),
                cuda_ms(lambda: st.decode(p_decode, w_k, offs), plain_reps)),
        }
        work = dense_work(rec["blocks"], cfg.block_bytes, st.cap, bits,
                          n_words, st.tb)
        rec["ms"] = {k: {"kernel": v[0], "plain": v[1], "bytes": work[k][0],
                         "operations": work[k][1], "bound": bound(work[k])}
                     for k, v in t.items()}
        rec["card"] = card
        if times is not None:
            times.update({k: (*v, work[k]) for k, v in t.items()})
    return rec


def compare_pack_full(card: str, errs: dict) -> dict:
    """Pack alone on random streams within two words of capacity, at every
    bit phase, at the safe capacity (256 words) and the speculative one
    (128): each block's shifted last word spills into its neighbour's
    first word, which encoded data at H = 2.2 never does."""
    from huffman_tpu_torch.ops import pack as p_pack
    from huffman_tpu_torch.ops.cuda import pack2 as k_pack
    from huffman_tpu_torch.ops.scan import exclusive_bit_offsets
    from huffman_tpu_torch.utils import testdata

    nb, e, total = 65536, 0, {}
    for cap in (256, 128):
        bits_np = np.random.default_rng(4).integers(cap * 32 - 64,
                                                    cap * 32 + 1, size=nb)
        streams = torch.from_numpy(testdata.random_block_streams(
            bits_np, cap, 4).view(np.int32)).cuda()
        bits = torch.from_numpy(bits_np.astype(np.int32)).cuda()
        offs = exclusive_bit_offsets(bits)
        n_words = int(offs.total_words)
        e = max(e, max_abs_err(
            Stages.pack(k_pack, streams, bits, offs, n_words),
            Stages.pack(p_pack, streams, bits, offs, n_words)))
        total[cap] = int(offs.total_bits)
    require(e == 0, f"pack_full_blocks: pack kernel != plain (max err {e})")
    errs["pack"] = max(errs.get("pack", 0), e)
    return {"phase": "kernels", "case": "pack_full_blocks", "blocks": nb,
            "total_bits_by_capacity": total, "max_abs_err": {"pack": e},
            "card": card}


def compare_pack_tiny(card: str, errs: dict) -> dict:
    """Pack alone on 65,536 blocks of 0..40 bits, a fifth of them empty, so
    that runs of blocks share one output word, at start phases 0 and 13 (a
    shard's), at capacity 4 (16-byte staging) and 2 (4-byte staging); then
    with one block in 64 at 200 bits, past its capacity, whose live words
    alone count."""
    from huffman_tpu_torch.ops import pack as p_pack
    from huffman_tpu_torch.ops.cuda import pack2 as k_pack
    from huffman_tpu_torch.ops.scan import exclusive_bit_offsets
    from huffman_tpu_torch.utils import testdata

    nb = 65536
    rng = np.random.default_rng(12)
    tiny = rng.integers(0, 41, size=nb)
    tiny[rng.permutation(nb)[: nb // 5]] = 0
    over = tiny.copy()
    over[::64] = 200
    e, words = 0, {}
    for label, bits_np in (("tiny", tiny), ("overflow", over)):
        for cap in (4, 2):
            streams = torch.from_numpy(testdata.random_block_streams(
                bits_np, cap, 12).view(np.int32)).cuda()
            bits = torch.from_numpy(bits_np.astype(np.int32)).cuda()
            for start in (0, 13):
                offs = exclusive_bit_offsets(bits, start)
                n_words = int(offs.total_words)
                e = max(e, max_abs_err(
                    Stages.pack(k_pack, streams, bits, offs, n_words),
                    Stages.pack(p_pack, streams, bits, offs, n_words)))
                words[f"{label}_cap{cap}_start{start}"] = n_words
    require(e == 0, f"pack_tiny_blocks: pack kernel != plain (max err {e})")
    errs["pack"] = max(errs.get("pack", 0), e)
    return {"phase": "kernels", "case": "pack_tiny_blocks", "blocks": nb,
            "stream_words": words, "max_abs_err": {"pack": e}, "card": card}


def hist_work(n: int) -> tuple:
    """(bytes, operations) of the histogram of n bytes: each byte read once
    and the 256 int64 bins written once; one count a byte."""
    return n + 256 * 8, n


def compare_histogram(card: str, main: np.ndarray, errs: dict, times: dict,
                      library: dict) -> dict:
    """The histogram kernel against its plain version (ops.histogram
    .histogram_plain, a scatter-add of ones) and torch.bincount on the same
    device bytes, exactly: the main profile at the kernel shapes (64 MiB),
    uniform bytes, one repeated byte, n_valid tails of 1-15 bytes, start
    offsets 1-15, the bytes as 32-bit words, and 5 GiB of one byte, whose
    count passes 2^32 (the plain version on 1 GiB slices, summed).  Times
    at 64 MiB: the kernel by graph replay, the plain version and bincount
    (library_ms) from events, since bincount syncs the host to size its
    bins and cannot be captured in a graph."""
    from huffman_tpu_torch.ops import histogram as hist_ops
    from huffman_tpu_torch.ops.cuda import histogram as k_hist

    dev = torch.device("cuda")
    err = 0
    cases = 0

    def check(name, kern, data, n):
        nonlocal err, cases
        want = torch.bincount(data[:n], minlength=256)
        e = max(max_abs_err(kern, want),
                max_abs_err(hist_ops.histogram_plain(data, n), want))
        require(e == 0, f"histogram {name}: kernel, plain and bincount "
                        f"differ (max err {e})")
        err, cases = max(err, e), cases + 1

    d_main = torch.from_numpy(main).to(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    inputs = {"main_profile": d_main,
              "uniform256": torch.randint(0, 256, (KERNEL_BYTES,),
                                          generator=g, dtype=torch.uint8,
                                          device=dev),
              "one_byte": torch.full((KERNEL_BYTES,), 45, dtype=torch.uint8,
                                     device=dev)}
    ms = {}
    for name, d in inputs.items():
        check(name, hist_ops.histogram(d), d, d.numel())
        ms[name] = graph_ms(lambda: k_hist.histogram(d, d.numel()), 20)
    head = d_main[: 1 << 20]
    for t in range(1, 16):
        n = (1 << 16) + t
        check(f"tail{t}", hist_ops.histogram(head, n), head, n)
        check(f"offset{t}", hist_ops.histogram(head[t:]), head[t:],
              head.numel() - t)
        check(f"offset{t}_tail{t}", hist_ops.histogram(head[t:], n - 16),
              head[t:], n - 16)
    check("short", hist_ops.histogram(head[3:10]), head[3:10], 7)
    words = d_main.view(torch.int32)
    for n in (d_main.numel(), d_main.numel() - 5, 4097):
        check(f"words_n{n}", hist_ops.histogram(words, n), d_main, n)
    big = torch.full((5 << 30,), 201, dtype=torch.uint8, device=dev)
    kern = hist_ops.histogram(big)
    plain = sum(hist_ops.histogram_plain(big[i: i + (1 << 30)], 1 << 30)
                for i in range(0, big.numel(), 1 << 30))
    want = torch.bincount(big, minlength=256)
    e = max(max_abs_err(kern, want), max_abs_err(plain, want))
    require(e == 0 and int(kern[201]) == 5 << 30,
            f"histogram 5 GiB: {int(kern[201])} != {5 << 30} (err {e})")
    del big, plain, want
    torch.cuda.empty_cache()
    errs["histogram"] = max(err, e)
    n = d_main.numel()
    plain_ms = cuda_ms(lambda: hist_ops.histogram_plain(d_main, n), 2)
    library["histogram"] = cuda_ms(
        lambda: torch.bincount(d_main, minlength=256), 5)
    work = hist_work(n)
    times["histogram"] = (ms["main_profile"], plain_ms, work)
    return {"phase": "kernels", "case": "histogram", "bytes": n,
            "cases_checked": cases + 1, "max_abs_err": errs["histogram"],
            "count_5GiB": 5 << 30, "kernel_ms": ms, "plain_ms": plain_ms,
            "bincount_ms": library["histogram"], "bytes_moved": work[0],
            "bound": bound(work), "card": card}


def scan_work(n: int, split: bool = True) -> tuple:
    """(bytes, operations) of the offset scan of n counts: each count read
    once, the int64 offsets (and the int32 bit shifts) and the two totals
    written once; one add a count."""
    return 4 * n + (12 if split else 8) * n + 16, n


def scan_equal(name: str, x: torch.Tensor, start: int = 0,
               scale: int = 1) -> int:
    """The offset scan kernel against its plain version on the same device
    counts, exactly: the dense offsets and totals (scale 1, from bit
    `start`) or the wide payload offsets and length (scale 2).  Returns
    the largest difference, which must be 0."""
    from huffman_tpu_torch.ops import scan as p_scan
    from huffman_tpu_torch.ops.cuda import scan as k_scan

    if scale == 1:
        got = k_scan.bit_offsets(x, start)
        want = p_scan.exclusive_bit_offsets_plain(x, start)
    else:
        got = k_scan.payload_offsets(x)
        want = p_scan.payload_offsets_plain(x)
    e = max(max_abs_err(a, b) for a, b in zip(got, want))
    require(e == 0, f"scan {name} (start {start}, scale {scale}): kernel "
                    f"!= plain (max err {e})")
    return e


def compare_scan(card: str, bits64: np.ndarray, errs: dict, times: dict,
                 library: dict) -> dict:
    """The offset scan kernel against its plain version (ops.scan
    .exclusive_bit_offsets_plain, the int64 torch.cumsum chain), exactly:
    the main profile's block bits at the kernel shapes (64 MiB) from every
    start bit 0..31; blocks at the 1 KiB block's capacity; 0, 1, a tile
    less or more one and 1,048,583 counts; counts that start 4 bytes past
    a 16-byte boundary; 262,144-byte blocks of 24-bit codes, whose total
    passes 2^32 bits and word_base 2^31, dense and as wide tile words; and
    a wide total past the kernel's status word (2^62 - 1), which must
    raise.  Times at 64 MiB: the kernel and the chain by graph replay (the
    chain's as library_ms), the plain version by events, as the other
    kernels' plain versions."""
    from huffman_tpu_torch.config import CodecConfig
    from huffman_tpu_torch.ops import scan as p_scan
    from huffman_tpu_torch.ops.cuda import scan as k_scan

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    tile = k_scan.TILE
    err, cases = 0, 0

    def check(name, x, start=0, scale=1):
        nonlocal err, cases
        err, cases = max(err, scan_equal(name, x, start, scale)), cases + 1

    d64 = torch.from_numpy(np.ascontiguousarray(bits64, np.int32)).to(dev)
    for start in range(32):
        check("main_profile", d64, start)
    cap_bits = CodecConfig().capacity_words * 32
    check("at_capacity", torch.full((65536,), cap_bits, dtype=torch.int32,
                                    device=dev), 7)
    for n in (0, 1, tile - 1, tile + 1, 1_048_583):
        x = torch.randint(0, 9001, (n,), generator=g, dtype=torch.int32,
                          device=dev)
        for start in (0, 31):
            check(f"n{n}", x, start)
        check(f"n{n}_wide", x, 0, 2)
    check("offset_4_bytes", d64[1:], 13)
    big_bits = 262144 * 24          # a 262,144-byte block of 24-bit codes
    big = torch.full((1_048_583,), big_bits, dtype=torch.int32, device=dev)
    check("past_2^32", big, 29)
    check("past_2^32_wide", big, 0, 2)
    offs = k_scan.bit_offsets(big, 29)
    total = int(offs.total_bits)
    require(total == 29 + big.numel() * big_bits and total > 1 << 32
            and int(offs.word_base[-1]) > 1 << 31,
            f"scan past_2^32: total {total}")
    del big, offs
    # 2^30 + 2 tile words of 2^31 - 1: the payload passes 2^62 - 1 words
    huge = torch.full(((1 << 30) + 2,), (1 << 31) - 1, dtype=torch.int32,
                      device=dev)
    try:
        k_scan.payload_offsets(huge)
        raise RuntimeError("check failed: scan past 2^62: no OverflowError")
    except OverflowError:
        pass
    del huge
    torch.cuda.empty_cache()
    errs["scan"] = err
    ms = graph_ms(lambda: p_scan.exclusive_bit_offsets(d64), 20)
    plain_ms = cuda_ms(lambda: p_scan.exclusive_bit_offsets_plain(d64), 20)
    library["scan"] = graph_ms(
        lambda: p_scan.exclusive_bit_offsets_plain(d64), 20)
    work = scan_work(d64.numel())
    times["scan"] = (ms, plain_ms, work)
    return {"phase": "kernels", "case": "scan", "blocks": d64.numel(),
            "cases_checked": cases, "max_abs_err": err,
            "past_2^32_total_bits": total, "past_2^62_refused": True,
            "kernel_ms": ms, "plain_ms": plain_ms,
            "chain_graph_ms": library["scan"], "bytes_moved": work[0],
            "bound": bound(work), "card": card}


def edge_data(n: int = 64 * 300 + 37):
    """Small explicit-codebook cases: with 64-byte blocks, a partial warp of
    16 lanes; a final partial block, a 4-byte group that is exactly 32
    bits, and groups of four 24-bit codes (96 bits per item)."""
    from huffman_tpu_torch.codebook import Codebook
    lens = np.zeros(256, np.int32)
    lens[:25] = list(range(1, 25)) + [24]          # Kraft sum exactly 1
    cb = Codebook.from_lengths(lens)
    rng = np.random.default_rng(7)
    data = np.zeros(n, np.uint8)
    data[rng.integers(0, data.size, 2000)] = rng.integers(1, 25, 2000)
    data[64:68] = 7                                 # four 8-bit codes
    data[128:132] = 24                              # four 24-bit codes
    data[200:208] = 23
    return data, cb


def compare_span(card: str, errs: dict) -> dict:
    """K4 through api.decode_block_span over blocks [b0, nb): the span
    starts at a block with a nonzero bit shift and ends at the stream's
    last word, against the plain version on the same span (on the host)
    and against the input."""
    from huffman_tpu_torch import api
    from huffman_tpu_torch.config import cdiv
    from huffman_tpu_torch.utils import testdata

    data = testdata.entropy_stream((4 << 20) - 333, seed=8)
    enc = api.encode(data, device="cuda")
    ends = np.cumsum(enc.block_bits.astype(np.int64))
    starts = ends - enc.block_bits
    nb, bb = len(ends), enc.config.block_bytes
    b0 = next(b for b in range(nb // 3, nb) if starts[b] & 31)
    require(cdiv(int(ends[-1]), 32) == enc.stream_words.size,
            "span: the last block does not end in the stream's last word")
    o_k = api.decode_block_span(enc, b0, nb, "cuda")
    o_p = api.decode_block_span(enc, b0, nb, "cpu")
    e = max_abs_err(o_k.cpu(), o_p)
    require(e == 0, f"dense_span: decode kernel != plain (max err {e})")
    require(np.array_equal(o_k.reshape(-1)[: data.size - b0 * bb].cpu()
                           .numpy(), data[b0 * bb:]),
            "dense_span: decoded bytes != input")
    errs["dense_decode"] = max(errs.get("dense_decode", 0), e)
    return {"phase": "kernels", "case": "dense_span_shifted_to_end",
            "bytes": int(data.size), "blocks": nb - b0, "first_block": b0,
            "first_bit_shift": int(starts[b0] & 31),
            "max_abs_err": {"dense_decode": e}, "card": card}


def api_roundtrip(name: str, data: np.ndarray, cfg, codebook=None) -> dict:
    """api.encode on the card equal to the golden encoder's stream, and
    api.decode and decode_range (across three blocks) equal to the input."""
    from huffman_tpu_torch import api, golden
    from huffman_tpu_torch.golden.numpy_codec import packed_bytes_to_words

    enc = api.encode(data, cfg, codebook=codebook, device="cuda")
    ref_bytes, ref_bits = golden.encode(data, enc.codebook)
    require(enc.total_bits == ref_bits and np.array_equal(
        enc.stream_words, packed_bytes_to_words(ref_bytes)),
        f"{name}: api.encode stream != golden encoder")
    require(np.array_equal(api.decode(enc, device="cuda"), data),
            f"{name}: api.decode != input")
    bb = cfg.block_bytes
    r0, r1 = bb - 100, min(data.size, 3 * bb + 333)
    require(np.array_equal(api.decode_range(enc, r0, r1, device="cuda"),
                           data[r0:r1]), f"{name}: decode_range != input")
    return {"api_golden_bit_exact": True, "api_roundtrip_exact": True,
            "api_decode_range": [r0, r1]}


def compare_large_blocks(card: str, errs: dict) -> None:
    """K1's CTA route on blocks past 4 KiB, which it walks in chunks of 1024
    words: through K1, pack and K4 against their plain versions, then
    through the API against the golden encoder and the input."""
    from huffman_tpu_torch.config import CodecConfig
    from huffman_tpu_torch.utils import testdata

    # the CLI's --block-bytes 8192 with 24-bit codes: two chunks a block,
    # 6144 words of capacity staged in shared memory
    data, cb = edge_data(8192 * 40 + 37)
    cfg = CodecConfig(block_bytes=8192, max_code_len=24,
                      capacity_bits_per_byte=24)
    rec = compare_kernels("large_bb8192_24bit", data, cfg, card, errs,
                          codebook=cb)
    rec.update(api_roundtrip("large_bb8192_24bit", data, cfg, cb))
    emit(rec)
    # the default config at 8192 bytes: the main profile's stream, which
    # does not depend on the block size
    main = testdata.entropy_stream(8 << 20, seed=11)
    rec = {"phase": "kernels", "case": "api_bb8192", "bytes": int(main.size),
           **api_roundtrip("api_bb8192", main, CodecConfig(block_bytes=8192)),
           "card": card}
    emit(rec)
    # 262,144-byte blocks: 65,536 words of capacity, more than a CTA's
    # shared memory, so K1 ORs each block's codes into device memory
    big = testdata.entropy_stream(4 * 262144 + 4099, seed=10)
    cfg = CodecConfig(block_bytes=262144)
    rec = compare_kernels("large_bb262144", big, cfg, card, errs,
                          plain_decode=False)
    rec.update(api_roundtrip("large_bb262144", big, cfg))
    emit(rec)


def driver_case(name: str, data: np.ndarray, card: str, codebook=None,
                **expect) -> dict:
    """api.encode_traced on the card: the trace's fields as `expect` says,
    K1 launched once a chunk on the first pass and once on each later
    pass, the stream equal to the golden encoder's under the final
    codebook, and api.decode equal to the input."""
    from huffman_tpu_torch import api, golden
    from huffman_tpu_torch.golden.numpy_codec import packed_bytes_to_words
    from huffman_tpu_torch.ops.cuda import encode as k_encode

    k_encode.launches.n = 0
    (enc, tr), enc_s = wall(lambda: api.encode_traced(data, codebook=codebook,
                                                      device="cuda"))
    k1 = k_encode.launches.n
    for k, v in expect.items():
        require(getattr(tr, k) == v, f"{name}: {k} {getattr(tr, k)} != {v}")
    require(k1 == max(tr.chunks, 1) + len(tr.capacities_tried) - 1,
            f"{name}: {k1} K1 launches for {tr}")
    ref_bytes, ref_bits = golden.encode(data, enc.codebook)
    require(enc.total_bits == ref_bits and np.array_equal(
        enc.stream_words, packed_bytes_to_words(ref_bytes)),
        f"{name}: api.encode stream != golden encoder")
    require(np.array_equal(api.decode(enc, device="cuda"), data),
            f"{name}: api.decode != input")
    return {"phase": "kernels", "case": name, "bytes": int(data.size),
            "sampled": tr.sampled, "rebuilt": tr.rebuilt,
            "capacities_tried": tr.capacities_tried, "chunks": tr.chunks,
            "k1_launches": k1, "bits_per_byte": enc.total_bits / data.size,
            "encode_e2e_s": enc_s, "golden_bit_exact": True,
            "roundtrip_exact": True, "card": card}


def driver_cases(card: str) -> None:
    """The encode driver's branches on the card: a sampled codebook that
    holds, a forced miss with its rebuild, a speculative capacity that one
    block overflows, chunked staging with a partial last chunk and block,
    and the ValueError of a given codebook on the chunked path."""
    from huffman_tpu_torch import api
    from huffman_tpu_torch.ops.cuda import encode as k_encode
    from huffman_tpu_torch.utils import testdata

    bb, every = 1024, api.SAMPLE_EVERY
    # 32 symbols at decay 0.75: the rarest is ~140 times in the sample
    emit(driver_case("sampled_hit", testdata.skewed(64 << 20, seed=12), card,
                     sampled=True, rebuilt=False, chunks=4))
    # bytes 201 and 202 only in blocks 1 .. every - 1, which the sample skips
    miss = testdata.entropy_stream(8 << 20, seed=13)
    miss[1 * bb: 1 * bb + 64] = 201
    miss[(every - 1) * bb: (every - 1) * bb + 64] = 202
    emit(driver_case("forced_miss", miss, card, sampled=True, rebuilt=True,
                     chunks=0))
    # 16 bytes at 1/128 each get 7-bit codes: every 8th byte is one, and
    # one block holds nothing else, past the 128-word speculative capacity
    # (~7200 bits) where the other blocks stay under 3300
    spec = testdata.entropy_stream(2 << 20, seed=14)
    spec[::8] = 200 + np.arange(spec.size // 8) % 16
    spec[1000 * bb: 1001 * bb] = 200 + np.arange(bb) % 16
    emit(driver_case("spec_retry", spec, card, sampled=False, rebuilt=False,
                     chunks=0, capacities_tried=[128, 256]))
    emit(driver_case("chunk_tail", testdata.entropy_stream((40 << 20) + 37,
                                                           seed=15),
                     card, sampled=True, chunks=3))
    # a given codebook without byte 250, which the second chunk holds
    data = testdata.entropy_stream(20 << 20, seed=16)
    cb = api.build_codebook(data, device="cuda")
    require(cb.lengths[250] == 0, "explicit_book: byte 250 has a code")
    data[(17 << 20) + 5] = 250
    k_encode.launches.n = 0
    try:
        api.encode(data, codebook=cb, device="cuda")
        raise RuntimeError("check failed: explicit_book: no ValueError")
    except ValueError as e:
        require("absent from the codebook" in str(e), f"explicit_book: {e}")
    require(k_encode.launches.n == 2, "explicit_book: K1 launches "
                                      f"{k_encode.launches.n} != 2 chunks")
    emit({"phase": "kernels", "case": "explicit_book_missing_byte",
          "bytes": int(data.size), "value_error": True, "k1_launches": 2,
          "card": card})


def phase_kernels(card: str, errs: dict, times: dict, library: dict) -> None:
    from huffman_tpu_torch import api
    from huffman_tpu_torch.codebook import Codebook
    from huffman_tpu_torch.config import CodecConfig
    from huffman_tpu_torch.utils import testdata

    cfg = CodecConfig()
    main = testdata.entropy_stream(KERNEL_BYTES, seed=1)
    # K1 at the capacity api.encode keeps for this input
    enc, tr = api.encode_traced(main, cfg, device="cuda")
    emit(compare_kernels("main_path_shapes", main, cfg, card, errs,
                         reps=20, plain_reps=2, times=times,
                         cap=tr.capacities_tried[-1]))

    uni = testdata.uniform_random(16 << 20, seed=2)
    emit(compare_histogram(card, main, errs, times, library))
    emit(compare_scan(card, enc.block_bits, errs, times, library))
    rec = compare_kernels("uniform256_at_capacity", uni, cfg, card, errs,
                          codebook=Codebook.from_lengths(np.full(256, 8)))
    require(rec["total_bits"] == uni.size * 8, "uniform: not 8 bits/byte")
    emit(rec)

    lens = np.zeros(256, np.int32)
    lens[:4] = [1, 2, 14, 14]
    d14 = np.zeros(4 << 20, np.uint8)
    d14[::7], d14[::13], d14[::17] = 1, 2, 3
    emit(compare_kernels("codes14_smem_table", d14,
                         CodecConfig(max_code_len=14), card, errs,
                         codebook=Codebook.from_lengths(lens)))

    lens = np.zeros(256, np.int32)
    lens[:21] = list(range(1, 21)) + [20]
    p = 2.0 ** -lens[:21].astype(np.float64)
    d20 = np.random.default_rng(3).choice(21, size=4 << 20,
                                          p=p / p.sum()).astype(np.uint8)
    emit(compare_kernels("codes20_global_table", d20,
                         CodecConfig(max_code_len=20), card, errs,
                         codebook=Codebook.from_lengths(lens)))

    emit(compare_pack_full(card, errs))
    emit(compare_pack_tiny(card, errs))

    data, cb = edge_data()
    emit(compare_kernels("edges_bb64_24bit", data,
                         CodecConfig(block_bytes=64, max_code_len=24,
                                     capacity_bits_per_byte=24),
                         card, errs, codebook=cb))
    # blocks past the warp route (1 KiB, 1024 words): K1's CTA per block
    data, cb = edge_data(4096 * 40 + 37)
    emit(compare_kernels("edges_bb4096_24bit", data,
                         CodecConfig(block_bytes=4096, max_code_len=24,
                                     capacity_bits_per_byte=24),
                         card, errs, codebook=cb))
    emit(compare_span(card, errs))
    compare_large_blocks(card, errs)
    driver_cases(card)


def parent_flow(data: np.ndarray, card: str) -> dict:
    """api.encode of the same input as the parent ran it (no sampling, no
    chunks, CodecConfig(spec_bits_per_byte=0): the exact codebook, one
    pageable copy, K1 at the safe capacity) beside the kernel path, in
    turns, with the walls side by side."""
    from huffman_tpu_torch import api
    from huffman_tpu_torch.config import CodecConfig

    saved = api.SAMPLE_MIN_BYTES, api.CHUNK_BLOCKS

    def parent():
        api.SAMPLE_MIN_BYTES = api.CHUNK_BLOCKS = 1 << 62
        try:
            return api.encode_traced(data, CodecConfig(spec_bits_per_byte=0),
                                     device="cuda")
        finally:
            api.SAMPLE_MIN_BYTES, api.CHUNK_BLOCKS = saved

    walls, traces = {"parent": [], "change": []}, {}
    for who in ("parent", "change", "change", "parent"):
        (enc, traces[who]), sec = wall(
            parent if who == "parent" else
            lambda: api.encode_traced(data, device="cuda"))
        walls[who].append(sec)
        del enc
    tr = traces["parent"]
    require(not tr.sampled and tr.chunks == 0
            and len(tr.capacities_tried) == 1, f"parent flow ran {tr}")
    return {"phase": "main_parent_flow", "bytes": int(data.size),
            "traces": {k: dataclasses.asdict(v) for k, v in traces.items()},
            "encode_wall_s": walls, "card": card}


def phase_main(card: str, data: np.ndarray) -> dict:
    from huffman_tpu_torch import api, container, golden
    from huffman_tpu_torch.golden.numpy_codec import (packed_bytes_to_words,
                                                      words_to_packed_bytes)
    from huffman_tpu_torch.ops import decode as p_decode
    from huffman_tpu_torch.ops import encode as p_encode
    from huffman_tpu_torch.ops import histogram as p_hist
    from huffman_tpu_torch.ops import pack as p_pack
    from huffman_tpu_torch.ops import scan as p_scan
    from huffman_tpu_torch.ops.cuda import dense_decode as k_decode
    from huffman_tpu_torch.ops.cuda import encode as k_encode
    from huffman_tpu_torch.ops.cuda import histogram as k_hist
    from huffman_tpu_torch.ops.cuda import pack2 as k_pack
    from huffman_tpu_torch.ops.cuda import scan as k_scan

    counters = [k_encode.launches, k_pack.launches, k_decode.launches,
                k_hist.launches, k_scan.launches, p_encode.cuda_calls,
                p_pack.cuda_calls, p_decode.cuda_calls, p_hist.cuda_calls,
                p_scan.cuda_calls]
    bb = 1024
    # decode_range from a block that starts at a nonzero bit shift is
    # chosen after the run, from its block bits; 6 KiB past it
    span = 6 * bb + 233

    # --- the main path, with every count at 0 just before it ---
    for c in counters:
        c.n = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc, trace = api.encode_traced(data, device="cuda")
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    blob = container.dumps(enc)
    enc2 = container.loads(blob)
    t0 = time.perf_counter()
    back = api.decode(enc2, device="cuda")
    dec_s = time.perf_counter() - t0
    ends = np.cumsum(enc2.block_bits.astype(np.int64))
    starts = ends - enc2.block_bits
    b0 = next(b for b in range(3, len(ends)) if starts[b] & 31)
    r0 = b0 * bb + 100
    r1 = r0 + span
    part = api.decode_range(enc2, r0, r1, device="cuda")
    torch.cuda.synchronize()
    launches = {"encode": k_encode.launches.n, "pack": k_pack.launches.n,
                "dense_decode": k_decode.launches.n,
                "histogram": k_hist.launches.n, "scan": k_scan.launches.n}
    plain_calls = {"encode": p_encode.cuda_calls.n,
                   "pack": p_pack.cuda_calls.n,
                   "dense_decode": p_decode.cuda_calls.n,
                   "histogram": p_hist.cuda_calls.n,
                   "scan": p_scan.cuda_calls.n}
    # --- end of the main path ---

    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path never launched: {launches}")
    require(not any(plain_calls.values()),
            f"a plain version ran on CUDA tensors: {plain_calls}")
    require(launches["encode"] == max(trace.chunks, 1)
            + len(trace.capacities_tried) - 1,
            f"K1 launches {launches['encode']} for {trace}")
    # the (sampled) codebook's histogram, and the exact one of a rebuild
    require(launches["histogram"] == 1 + trace.rebuilt,
            f"histogram launches {launches['histogram']} for {trace}")
    # the offsets of the encode's pack and of api.decode (decode_range
    # scans its span on the host)
    require(launches["scan"] == 2, f"scan launches {launches['scan']} != 2")
    t0 = time.perf_counter()
    ref_bytes, ref_bits = golden.encode(data, enc.codebook)
    golden_s = time.perf_counter() - t0
    require(enc.total_bits == ref_bits,
            f"total_bits {enc.total_bits} != golden {ref_bits}")
    require(np.array_equal(enc.stream_words, packed_bytes_to_words(ref_bytes)),
            "stream words != golden encoder")
    del ref_bytes
    require(np.array_equal(back, data), "container roundtrip != input")
    require(np.array_equal(part, data[r0:r1]), "decode_range != input")
    # the golden decoder from the same block's first bit, at its shift
    b1 = -(-r1 // bb)
    w0, w1 = int(starts[b0] >> 5), -(-int(ends[b1 - 1]) // 32)
    gold = golden.decode(words_to_packed_bytes(
        enc.stream_words[w0:w1], (w1 - w0) * 32), r1 - b0 * bb,
        enc.codebook, int(starts[b0] & 31))
    require(np.array_equal(gold[r0 - b0 * bb:], part),
            "decode_range != golden decoder")
    exact = api.build_codebook(data, device="cuda")

    # kernel-only rates on device-resident data at the same size: encode
    # is K1 (at the capacity the path kept) + offset scan + pack, decode K4
    from huffman_tpu_torch.config import CodecConfig
    from huffman_tpu_torch.ops.encode import BITS_MASK
    from huffman_tpu_torch.ops.scan import exclusive_bit_offsets
    cap = trace.capacities_tried[-1]
    st = Stages(data, CodecConfig(), enc.codebook, cap)
    n_words = enc.stream_words.size

    def enc_kernels():
        s, b = st.encode(k_encode)
        b = b & BITS_MASK
        return st.pack(k_pack, s, b, exclusive_bit_offsets(b), n_words)

    w_k = enc_kernels()
    bits_t = torch.from_numpy(enc.block_bits).cuda()
    offs = exclusive_bit_offsets(bits_t)
    require(np.array_equal(w_k.cpu().numpy().view(np.uint32),
                           enc.stream_words), "device-resident encode != api")
    enc_ms = cuda_ms(enc_kernels, 5)
    dec_ms = graph_ms(lambda: st.decode(k_decode, w_k, offs), 5)
    # K1 at the speculative and the safe capacity, each beside its bound
    k1 = {}
    for c in (128, 256):
        k1[c] = graph_ms(lambda: st.encode(k_encode, c), 5)
    # pack and the offset scan alone, on K1's streams of this input
    s_k, b_k = st.encode(k_encode)
    b_k = b_k & BITS_MASK
    offs_k = exclusive_bit_offsets(b_k)
    pack_ms = graph_ms(lambda: st.pack(k_pack, s_k, b_k, offs_k, n_words), 5)
    # the scan against its plain version on these bits, 20 times over (a
    # look-back race would show as a difference), and both timed
    for _ in range(20):
        scan_equal("main_1GiB", b_k)
    scan_ms = graph_ms(lambda: exclusive_bit_offsets(b_k), 5)
    scan_chain_ms = graph_ms(
        lambda: p_scan.exclusive_bit_offsets_plain(b_k), 5)
    scan_bound = bound(scan_work(b_k.numel()))[0]
    del s_k, b_k, offs_k
    # the histogram of the resident input, and torch.bincount's (events:
    # it syncs the host)
    flat = st.blocks.reshape(-1)
    hist_ms = graph_ms(lambda: k_hist.histogram(flat, data.size), 5)
    bincount_ms = cuda_ms(lambda: torch.bincount(flat[: data.size],
                                                 minlength=256), 2)
    hist_bound = bound(hist_work(data.size))[0]
    del flat
    nb = len(enc.block_bits)
    work = {c: dense_work(nb, bb, c, bits_t, n_words, st.tb)
            for c in (128, 256)}
    k1_bound = {c: bound(work[c]["encode"])[0] for c in (128, 256)}
    pack_bound = bound(work[cap]["pack"])[0]
    enc_bound = bound(work[cap]["encode"])[0] + pack_bound
    dec_bound = bound(work[cap]["dense_decode"])[0]
    del st, w_k
    gb = data.size / 1e9
    emit({"phase": "main", "bytes": int(data.size), "blocks": nb,
          "sampled": trace.sampled, "rebuilt": trace.rebuilt,
          "capacities_tried": trace.capacities_tried,
          "chunks": trace.chunks, "k1_launches": launches["encode"],
          "total_bits": enc.total_bits, "bits_per_byte": enc.total_bits / data.size,
          "final_book_est_bpb": enc.codebook.est_bpb,
          "exact_book_est_bpb": exact.est_bpb,
          "final_book_is_exact": bool(np.array_equal(enc.codebook.lengths,
                                                     exact.lengths)),
          "codebook_max_len": enc.codebook.max_len,
          "golden_bit_exact": True, "roundtrip_exact": True,
          "decode_range": [r0, r1], "decode_range_exact": True,
          "decode_range_bit_shift": int(starts[b0] & 31),
          "decode_range_golden_decoder": True,
          "launches": launches, "plain_calls_on_cuda": plain_calls,
          "golden_encode_s": golden_s,
          "encode_e2e_s": enc_s, "decode_e2e_s": dec_s,
          "encode_e2e_GBps": gb / enc_s, "decode_e2e_GBps": gb / dec_s,
          "encode_kernels_ms": enc_ms, "decode_kernel_ms": dec_ms,
          "encode_kernels_GBps": gb / (enc_ms / 1e3),
          "decode_kernel_GBps": gb / (dec_ms / 1e3),
          "encode_kernels_bound_ms": enc_bound,
          "encode_kernel_capacity_words": cap,
          "encode_kernel_ms": k1[cap],
          "encode_kernel_bytes": work[cap]["encode"][0],
          "encode_kernel_bound_ms": k1_bound[cap],
          "encode_kernel_bound_share": k1_bound[cap] / k1[cap],
          "encode_kernel_by_capacity": {
              c: {"ms": k1[c], "bytes": work[c]["encode"][0],
                  "bound_ms": k1_bound[c],
                  "bound_share": k1_bound[c] / k1[c]} for c in (128, 256)},
          "pack_kernel_ms": pack_ms, "pack_kernel_bytes": work[cap]["pack"][0],
          "pack_kernel_bound_ms": pack_bound,
          "pack_kernel_bound_share": pack_bound / pack_ms,
          "scan_ms": scan_ms, "scan_chain_ms": scan_chain_ms,
          "scan_bytes": scan_work(nb)[0], "scan_bound_ms": scan_bound,
          "scan_bound_share": scan_bound / scan_ms,
          "scan_repeats_exact": 20,
          "histogram_kernel_ms": hist_ms,
          "histogram_kernel_bytes": hist_work(data.size)[0],
          "histogram_kernel_bound_ms": hist_bound,
          "histogram_kernel_bound_share": hist_bound / hist_ms,
          "histogram_bincount_ms": bincount_ms,
          "decode_kernel_bytes": work[cap]["dense_decode"][0],
          "decode_kernel_bound_ms": dec_bound,
          "decode_kernel_bound_share": dec_bound / dec_ms,
          "card": card})
    emit(parent_flow(data, card))
    return launches, enc, exact, {"encode": enc_s, "decode": dec_s}


def crc_work(n_words: int) -> tuple:
    """(bytes, operations) of the swap and CRC over n_words: each word read
    and written once; the table lookups and shifts are not counted (the
    card's bound is its memory)."""
    return 8 * n_words, 0


def phase_device(card: str, data: np.ndarray, host_enc, errs: dict,
                 times: dict) -> dict:
    """The payload swap and CRC kernel, then the main input through the
    card-resident path (api.encode of a CUDA tensor, dumps_device,
    loads_device, api.decode).  Returns the kernels' launches on that
    path."""
    import zlib

    from huffman_tpu_torch import api, container
    from huffman_tpu_torch.ops import crc32 as p_crc
    from huffman_tpu_torch.ops.cuda import crc32 as k_crc
    from huffman_tpu_torch.utils import timing

    dev = torch.device("cuda")
    cases = 0

    def crc_of(t: torch.Tensor) -> int:
        return int(t.cpu().numpy().view(np.uint32)[0])

    def check(name: str, host_words: np.ndarray, src: torch.Tensor) -> None:
        """Both directions on src (host_words on the card) against the
        plain version and zlib."""
        nonlocal cases
        want = zlib.crc32(host_words.astype(">u4").tobytes())
        w = src.numel()
        out, crc = (torch.empty(w, dtype=torch.int32, device=dev),
                    torch.empty(1, dtype=torch.int32, device=dev))
        k_crc.swap_crc32(src, out, crc, True)
        p_out, p_crc_t = torch.empty_like(out), torch.empty_like(crc)
        p_crc.swap_crc32_plain(src, p_out, p_crc_t, True)
        require(torch.equal(out, p_out), f"crc32 {name}: payload != plain")
        require(crc_of(crc) == crc_of(p_crc_t) == want,
                f"crc32 {name}: {crc_of(crc):#x}, plain "
                f"{crc_of(p_crc_t):#x}, zlib {want:#x}")
        back = torch.empty_like(out)
        k_crc.swap_crc32(out, back, crc, False)
        require(torch.equal(back, src), f"crc32 {name}: loads way != input")
        require(crc_of(crc) == want, f"crc32 {name}: loads way's CRC")
        cases += 1

    main_words = host_enc.stream_words
    rng = np.random.default_rng(5)
    for w in (0, 1, 31, 1023, 1024, 1025, 1024 * 1024 + 3):
        words = rng.integers(0, 2**32, w, dtype=np.uint64).astype(np.uint32)
        # at a 4-byte offset in a byte buffer, as a container's payload
        raw = torch.empty(4 * w + 8, dtype=torch.uint8, device=dev)
        src = raw[4: 4 + 4 * w].view(torch.int32)
        src.copy_(torch.from_numpy(words.view(np.int32)).to(dev))
        check(f"words_{w}_offset4", words, src)
    src = torch.from_numpy(main_words.view(np.int32)).to(dev)
    check("main_stream", main_words, src)
    errs["crc32"] = 0
    n_main = src.numel()
    out = torch.empty_like(src)
    crc = torch.empty(1, dtype=torch.int32, device=dev)
    ms = {}
    for name, w in (("main", n_main), ("sixteenth", n_main // 16)):
        a, b = src[:w], out[:w]
        # the loads way writes a's words back over a
        ms[name] = {
            "dumps_way": graph_ms(lambda: k_crc.swap_crc32(a, b, crc, True),
                                  5),
            "loads_way": graph_ms(lambda: k_crc.swap_crc32(b, a, crc, False),
                                  5)}
    plain_ms = cuda_ms(lambda: p_crc.swap_crc32_plain(
        src[: n_main // 16], out[: n_main // 16], crc, True), 1)
    times["crc32"] = (ms["sixteenth"]["dumps_way"], plain_ms,
                      crc_work(n_main // 16))
    bound_ms = bound(crc_work(n_main))[0]
    del src, out

    # the main input through the card-resident path
    blob = container.dumps(host_enc)
    x = torch.from_numpy(data).to(dev)
    kernels, plain = path_counters()
    counters = {k: kernels[k] for k in ("encode", "pack", "histogram",
                                        "scan", "dense_decode")}
    counters["crc32"] = k_crc.launches
    for c in [*counters.values(), *plain.values(), p_crc.cuda_calls]:
        c.n = 0
    before = {k: c.n for k, c in timing.copied.items()}
    walls = {}

    def stage(name, fn):
        out, walls[name] = wall(fn)
        return out

    enc, trace = stage("encode", lambda: api.encode_traced(x, device="cuda"))
    buf = stage("dumps", lambda: container.dumps_device(enc))
    back = stage("loads", lambda: container.loads_device(buf))
    y = stage("decode", lambda: api.decode(back, device="cuda"))
    launches = {k: c.n for k, c in counters.items()}
    plain_calls = {k: c.n for k, c in plain.items()}
    plain_calls["crc32"] = p_crc.cuda_calls.n
    moved = sum(c.n - before[k] for k, c in timing.copied.items())
    require(isinstance(enc, api.ResidentEncoded) and y.is_cuda,
            "the card-resident path left the card")
    require(buf.numel() == len(blob) and torch.equal(
        buf, torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(dev)),
        "dumps_device != dumps of the host encode")
    require(torch.equal(y, x), "card-resident roundtrip != input")
    require(not any(plain_calls.values()),
            f"a plain version ran on CUDA tensors: {plain_calls}")
    # a sampled tensor's histograms: the sample's and the exact one, both
    # before K1, which then runs once a capacity tried
    require(trace.sampled and len(trace.capacities_tried) == 1
            and launches["encode"] == 1
            and launches["histogram"] == 2
            and launches["scan"] == 2 and launches["pack"] == 1
            and launches["dense_decode"] == 1 and launches["crc32"] == 2,
            f"card-resident launches {launches} for {trace}")
    require(moved < data.size / 100, f"{moved} bytes crossed")
    # slices of the resident input 1 and 4 bytes past a 16-byte address,
    # which K1 (word loads) must not read in place
    sliced = 64 << 20
    for off in (1, 4):
        sl = x[off: off + sliced]
        got = container.dumps_device(api.encode(sl, device="cuda"))
        want = container.dumps(api.encode(data[off: off + sliced],
                                          device="cuda"))
        require(got.numel() == len(want) and torch.equal(got, torch.frombuffer(
            bytearray(want), dtype=torch.uint8).to(dev)),
            f"offset {off}: dumps_device != dumps of the host encode")
        require(torch.equal(api.decode(container.loads_device(got),
                                       device="cuda"), sl),
                f"offset {off}: card-resident roundtrip != input")
        torch.cuda.synchronize()
    gb = data.size / 1e9
    rec = {"phase": "device", "crc32_cases": cases,
           "crc32_stream_words": n_main, "crc32_ms": ms,
           "crc32_bytes": crc_work(n_main)[0], "crc32_bound_ms": bound_ms,
           "crc32_bound_share": {k: bound_ms / v for k, v in
                                 ms["main"].items()},
           "crc32_plain_ms_sixteenth": plain_ms,
           "container_equal_host": True, "roundtrip_exact": True,
           "offset_slices_exact": [1, 4], "offset_slice_bytes": sliced,
           "sampled": trace.sampled, "rebuilt": trace.rebuilt,
           "capacities_tried": trace.capacities_tried,
           "launches": launches, "plain_calls_on_cuda": plain_calls,
           "bytes_crossed": moved, "bytes_crossed_share": moved / data.size,
           "walls_s": walls,
           "encode_GBps": gb / (walls["encode"] + walls["dumps"]),
           "decode_GBps": gb / (walls["loads"] + walls["decode"]),
           "card": card}
    emit(rec)
    del x, y, buf, back, enc
    torch.cuda.empty_cache()
    return launches


class WideStages:
    """The wide path's kernels (K5, the schedule and K7, K8) next to their
    plain versions, on device-resident inputs prepared once."""

    def __init__(self, data: np.ndarray, codebook=None):
        from huffman_tpu_torch import api, wide
        from huffman_tpu_torch.config import CodecConfig
        from huffman_tpu_torch.ops.decode import table_entries
        dev = torch.device("cuda")
        self.rows, self.valid = wide.device_substreams(data, dev)
        self.cb = codebook or api.codebook_for(self.rows, data.size,
                                               CodecConfig())
        self.mcl = wide.reader_mcl(self.cb)
        self.slot = wide.slot_words(self.mcl)
        self.codes = torch.from_numpy(
            self.cb.codes.astype(np.uint32).view(np.int32)).cuda()
        self.lengths = torch.from_numpy(self.cb.lengths.astype(np.int32)).cuda()
        self.nt = self.rows.shape[0] // 1024
        self.tile_bytes = torch.from_numpy(
            wide.tile_bytes(data.size, 0, self.nt)).cuda()
        self.table = torch.from_numpy(table_entries(self.cb, self.mcl)).cuda()

    def sub_encode(self, mod):
        return mod.sub_encode(self.rows, self.codes, self.lengths, self.valid,
                              self.slot)

    def schedule(self, mod, l2):
        return mod.schedule_counts(l2, self.tile_bytes, self.mcl)

    @staticmethod
    def emit(mod, streams, masks, bases, tile_words, offs, n_words: int):
        return mod.emit_planes(streams, masks, bases, tile_words, offs,
                               n_words)

    def decode(self, mod, payload, offs, tile_words, bases):
        return mod.decode_tiles(payload, offs, tile_words, bases,
                                self.tile_bytes, self.table, self.mcl)


def spec_tile_ok(data: np.ndarray, t: int, cb, payload: np.ndarray,
                 start: int, tile_words: int, bases: np.ndarray) -> bool:
    """Tile t of an encoded payload (P0 at `start`) equals the format
    specification's encoder on that tile."""
    from huffman_tpu_torch.golden import wide_codec as W
    p0, p1, b = W.encode_tile(data[t * W.TILE_BYTES: (t + 1) * W.TILE_BYTES],
                              cb.codes, cb.lengths)
    return (p0.size == tile_words and np.array_equal(bases, b)
            and np.array_equal(payload[start: start + tile_words], p0)
            and np.array_equal(payload[start + tile_words:
                                       start + 2 * tile_words], p1))


def compare_wide(name: str, data: np.ndarray, card: str, errs: dict,
                 codebook=None, reps: int = 0, plain_reps: int = 0,
                 times: dict | None = None, spec_tiles: int = 0) -> dict:
    """Each wide kernel against its plain version on the same device
    inputs; every output must match exactly, the decoded bytes must equal
    the input, and the first `spec_tiles` tiles the specification."""
    from huffman_tpu_torch import wide
    from huffman_tpu_torch.ops import wide as p_wide
    from huffman_tpu_torch.ops.cuda import wide_decode as k_wdec
    from huffman_tpu_torch.ops.cuda import wide_emit as k_emit
    from huffman_tpu_torch.ops.cuda import wide_encode as k_sub

    st = WideStages(data, codebook)
    rec = {"phase": "wide_kernels", "case": name, "bytes": int(data.size),
           "tiles": st.nt, "mcl": st.mcl, "slot_words": st.slot}
    s_k, b_k, l_k = st.sub_encode(k_sub)
    s_p, b_p, l_p = st.sub_encode(p_wide)
    e_sub = max(max_abs_err(s_k, s_p), max_abs_err(b_k, b_p),
                max_abs_err(l_k, l_p))
    require(e_sub == 0, f"{name}: K5 kernel != plain (max err {e_sub})")
    bases, tw, masks = st.schedule(k_emit, l_k)
    bases_p, tw_p, masks_p = st.schedule(p_wide, l_k)
    e_sched = max(max_abs_err(bases, bases_p), max_abs_err(tw, tw_p),
                  max_abs_err(masks, masks_p))
    require(e_sched == 0, f"{name}: schedule kernel != plain "
                          f"(max err {e_sched})")
    offs, n_words = wide.payload_offsets(tw)
    pay_k = st.emit(k_emit, s_k, masks, bases, tw, offs, n_words)
    pay_p = st.emit(p_wide, s_k, masks, bases, tw, offs, n_words)
    e_emit = max(e_sched, max_abs_err(pay_k, pay_p))
    require(e_emit == 0, f"{name}: K7 kernel != plain (max err {e_emit})")
    o_k = st.decode(k_wdec, pay_k, offs, tw, bases)
    o_p = st.decode(p_wide, pay_k, offs, tw, bases)
    e_dec = max_abs_err(o_k, o_p)
    require(e_dec == 0, f"{name}: K8 kernel != plain (max err {e_dec})")
    back = o_k.reshape(-1)[: data.size].cpu().numpy()
    require(np.array_equal(back, data), f"{name}: decoded bytes != input")
    payload = pay_k.cpu().numpy().view(np.uint32)
    tw_h, offs_h, bases_h = tw.cpu().numpy(), offs.cpu().numpy(), \
        bases.cpu().numpy()
    for t in range(min(spec_tiles, st.nt)):
        require(spec_tile_ok(data, t, st.cb, payload, int(offs_h[t]),
                             int(tw_h[t]), bases_h[t]),
                f"{name}: tile {t} != the format specification")
    for k, e in (("wide_sub_encode", e_sub), ("wide_emit", e_emit),
                 ("wide_decode", e_dec)):
        errs[k] = max(errs.get(k, 0), e)
    rec.update({"payload_words": n_words,
                "bits_per_byte": n_words * 32 / max(data.size, 1),
                "max_substream_bits": int(b_k.max()),
                "spec_tiles_checked": min(spec_tiles, st.nt),
                "max_abs_err": {"wide_sub_encode": e_sub,
                                "wide_emit": e_emit, "wide_decode": e_dec}})
    if reps:
        def emit_all(mod):
            b, w, msk = st.schedule(mod, l_k)
            return st.emit(mod, s_k, msk, b, w, offs, n_words)
        t = {
            "wide_sub_encode": (graph_ms(lambda: st.sub_encode(k_sub), reps),
                                cuda_ms(lambda: st.sub_encode(p_wide),
                                        plain_reps)),
            "wide_schedule": (graph_ms(lambda: st.schedule(k_emit, l_k),
                                       reps),
                              cuda_ms(lambda: st.schedule(p_wide, l_k),
                                      plain_reps)),
            "wide_emit": (graph_ms(lambda: emit_all(k_emit), reps),
                          cuda_ms(lambda: emit_all(p_wide), plain_reps)),
            "wide_decode": (
                graph_ms(lambda: st.decode(k_wdec, pay_k, offs, tw, bases),
                         reps),
                cuda_ms(lambda: st.decode(p_wide, pay_k, offs, tw, bases),
                        plain_reps)),
        }
        work = wide_work(st.nt, st.slot, n_words, st.mcl)
        rec["ms"] = {k: {"kernel": v[0], "plain": v[1], "bytes": work[k][0],
                         "operations": work[k][1], "bound": bound(work[k])}
                     for k, v in t.items()}
        rec["ms_note"] = ("wide_emit is the schedule and the emit kernel; "
                          "its work counts both")
        rec["card"] = card
        if times is not None:
            times.update({k: (*v, work[k]) for k, v in t.items()})
    return rec


def compare_sub_encode_rows(card: str, errs: dict) -> dict:
    """K5 alone on a row count that is not a multiple of its four rows a
    warp (the wide path always passes whole tiles of 1024), the last row
    partial, against its plain version."""
    from huffman_tpu_torch.ops import wide as p_wide
    from huffman_tpu_torch.ops.cuda import wide_encode as k_sub
    from huffman_tpu_torch.utils import testdata

    ns = 1021
    st = WideStages(testdata.entropy_stream(256 * ns - 100, seed=9))
    rows, valid = st.rows[:ns], st.valid[:ns]
    outs = [mod.sub_encode(rows, st.codes, st.lengths, valid, st.slot)
            for mod in (k_sub, p_wide)]
    e = max(max_abs_err(k, p) for k, p in zip(*outs))
    require(e == 0, f"sub_encode_1021_rows: K5 kernel != plain (max err {e})")
    errs["wide_sub_encode"] = max(errs.get("wide_sub_encode", 0), e)
    return {"phase": "wide_kernels", "case": "sub_encode_1021_rows",
            "rows": ns, "max_abs_err": {"wide_sub_encode": e}, "card": card}


def phase_wide_kernels(card: str, errs: dict, times: dict) -> None:
    from huffman_tpu_torch.codebook import Codebook
    from huffman_tpu_torch.golden.wide_codec import TILE_BYTES
    from huffman_tpu_torch.utils import testdata

    main = testdata.entropy_stream(KERNEL_BYTES, seed=1)
    emit(compare_wide("main_path_shapes", main, card, errs, reps=20,
                      plain_reps=2, times=times, spec_tiles=2))

    uni = testdata.uniform_random(16 << 20, seed=2)
    rec = compare_wide("uniform256_codes8", uni, card, errs,
                       codebook=Codebook.from_lengths(np.full(256, 8)),
                       spec_tiles=1)
    require(rec["bits_per_byte"] == 8.0, "uniform: not 8 bits/byte")
    emit(rec)

    # the format's maximum: 12-bit codes fill whole substreams (96 words)
    lens = np.zeros(256, np.int32)
    lens[:13] = list(range(1, 13)) + [12]          # Kraft sum exactly 1
    p = 2.0 ** -lens[:13]
    rng = np.random.default_rng(3)
    d12 = rng.choice(13, size=16 << 20, p=p / p.sum()).astype(np.uint8)
    d12[: 4 * TILE_BYTES] = rng.integers(11, 13, size=4 * TILE_BYTES)
    rec = compare_wide("codes12_full_substreams", d12, card, errs,
                       codebook=Codebook.from_lengths(lens), spec_tiles=1)
    require(rec["max_substream_bits"] == 256 * 12, "no 96-word substream")
    emit(rec)

    lens = np.zeros(256, np.int32)
    lens[:8] = [2, 2, 3, 3, 4, 4, 4, 4]
    p = 2.0 ** -lens[:8]
    d4 = rng.choice(8, size=4 << 20, p=p / p.sum()).astype(np.uint8)
    rec = compare_wide("narrow_mcl4", d4, card, errs,
                       codebook=Codebook.from_lengths(lens), spec_tiles=1)
    require(rec["mcl"] == 4, "narrow book is not mcl 4")
    emit(rec)

    emit(compare_sub_encode_rows(card, errs))

    # partial last tile with 3 (no power of two) tiles; one sub-tile input
    edge = testdata.skewed(3 * TILE_BYTES - 5000, num_symbols=40, seed=5)
    emit(compare_wide("tiles3_partial", edge, card, errs, spec_tiles=3))
    small = testdata.skewed(5000, num_symbols=256, decay=0.97, seed=6)
    emit(compare_wide("subtile_5000", small, card, errs, spec_tiles=1))


def phase_wide_main(card: str, data: np.ndarray, dense_bits: int) -> dict:
    from huffman_tpu_torch import container, wide
    from huffman_tpu_torch.golden.wide_codec import TILE_BYTES
    from huffman_tpu_torch.ops import histogram as p_hist
    from huffman_tpu_torch.ops import scan as p_scan
    from huffman_tpu_torch.ops import wide as p_wide
    from huffman_tpu_torch.ops.cuda import histogram as k_hist
    from huffman_tpu_torch.ops.cuda import scan as k_scan
    from huffman_tpu_torch.ops.cuda import wide_decode as k_wdec
    from huffman_tpu_torch.ops.cuda import wide_emit as k_emit
    from huffman_tpu_torch.ops.cuda import wide_encode as k_sub

    counters = [k_sub.launches, k_emit.schedule_launches, k_emit.launches,
                k_wdec.launches, k_hist.launches, k_scan.launches,
                p_hist.cuda_calls, p_scan.cuda_calls,
                *p_wide.cuda_calls.values()]

    # --- the wide path, with every count at 0 just before it ---
    for c in counters:
        c.n = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = wide.encode_wide(data, device="cuda")
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blob = container.dumps_wide(enc)
    dumps_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    enc2 = container.loads_wide(blob)
    loads_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = wide.decode_wide(enc2, device="cuda")
    dec_s = time.perf_counter() - t0
    r0, r1 = 5 * TILE_BYTES - 1000, 7 * TILE_BYTES + 333
    part = wide.decode_wide_range(enc2, r0, r1, device="cuda")
    torch.cuda.synchronize()
    launches = {"wide_sub_encode": k_sub.launches.n,
                "wide_schedule": k_emit.schedule_launches.n,
                "wide_emit": k_emit.launches.n,
                "wide_decode": k_wdec.launches.n,
                "histogram": k_hist.launches.n, "scan": k_scan.launches.n}
    plain_calls = {**{k: c.n for k, c in p_wide.cuda_calls.items()},
                   "histogram": p_hist.cuda_calls.n,
                   "scan": p_scan.cuda_calls.n}
    # --- end of the wide path ---

    require(all(v > 0 for v in launches.values()),
            f"a kernel of the wide path never launched: {launches}")
    require(not any(plain_calls.values()),
            f"a plain version ran on CUDA tensors: {plain_calls}")
    require(launches["histogram"] == 1,
            f"wide histogram launches {launches['histogram']} != 1")
    # the payload offsets of the encode (the decodes' are the host's)
    require(launches["scan"] == 1,
            f"wide scan launches {launches['scan']} != 1")
    require(np.array_equal(back, data), "wide container roundtrip != input")
    require(np.array_equal(part, data[r0:r1]), "decode_wide_range != input")
    nt = len(enc.tile_words)
    require(nt == -(-data.size // TILE_BYTES), f"tile count {nt}")
    starts = np.concatenate([[0], np.cumsum(2 * enc.tile_words.astype(
        np.int64))])
    checked = list(range(WIDE_GOLDEN_TILES)) + [nt - 1]
    t0 = time.perf_counter()
    for t in checked:
        require(spec_tile_ok(data, t, enc.codebook, enc.payload_words,
                             int(starts[t]), int(enc.tile_words[t]),
                             enc.bases[t]),
                f"wide tile {t} != the format specification")
    spec_s = time.perf_counter() - t0

    # kernel-only rates on device-resident data at the same size: encode is
    # K5 + schedule + offsets + K7, decode is K8
    st = WideStages(data, enc.codebook)
    n_words = enc.payload_words.size

    def enc_kernels():
        s, _, l2 = st.sub_encode(k_sub)
        b, w, msk = st.schedule(k_emit, l2)
        offs, nw = wide.payload_offsets(w)
        return st.emit(k_emit, s, msk, b, w, offs, nw), b, w, offs

    pay, bases, tw, offs = enc_kernels()
    require(np.array_equal(pay.cpu().numpy().view(np.uint32),
                           enc.payload_words), "device-resident encode != api")
    scan_equal("wide_main_1GiB", tw, 0, 2)
    enc_ms = cuda_ms(enc_kernels, 5)
    k5_ms = graph_ms(lambda: st.sub_encode(k_sub), 5)
    dec_ms = graph_ms(lambda: st.decode(k_wdec, pay, offs, tw, bases), 5)
    s_k, _, l2_k = st.sub_encode(k_sub)

    def sched_emit():
        b, w, msk = st.schedule(k_emit, l2_k)
        return st.emit(k_emit, s_k, msk, b, w, offs, n_words)
    emit_ms = graph_ms(sched_emit, 5)
    work = wide_work(nt, st.slot, n_words, st.mcl)
    k5_bound = bound(work["wide_sub_encode"])[0]
    emit_bound = bound(work["wide_emit"])[0]
    enc_bound = k5_bound + emit_bound
    dec_bound = bound(work["wide_decode"])[0]
    del st, pay, s_k, l2_k
    gb = data.size / 1e9
    emit({"phase": "wide_main", "bytes": int(data.size), "tiles": nt,
          "payload_words": int(n_words),
          "bits_per_byte": n_words * 32 / data.size,
          "dense_bits_per_byte": dense_bits / data.size,
          "codebook_max_len": enc.codebook.max_len,
          "roundtrip_exact": True, "decode_range": [r0, r1],
          "decode_range_exact": True, "spec_tiles_checked": checked,
          "spec_check_s": spec_s, "launches": launches,
          "plain_calls_on_cuda": plain_calls,
          "encode_e2e_s": enc_s, "decode_e2e_s": dec_s,
          "container_dumps_s": dumps_s, "container_loads_s": loads_s,
          "encode_e2e_GBps": gb / enc_s, "decode_e2e_GBps": gb / dec_s,
          "encode_kernels_ms": enc_ms, "decode_kernel_ms": dec_ms,
          "encode_kernels_GBps": gb / (enc_ms / 1e3),
          "decode_kernel_GBps": gb / (dec_ms / 1e3),
          "encode_kernels_bound_ms": enc_bound,
          "sub_encode_kernel_ms": k5_ms,
          "sub_encode_kernel_bytes": work["wide_sub_encode"][0],
          "sub_encode_kernel_bound_ms": k5_bound,
          "sub_encode_kernel_bound_share": k5_bound / k5_ms,
          "schedule_emit_kernels_ms": emit_ms,
          "schedule_emit_kernels_bytes": work["wide_emit"][0],
          "schedule_emit_kernels_bound_ms": emit_bound,
          "schedule_emit_kernels_bound_share": emit_bound / emit_ms,
          "decode_kernel_bytes": work["wide_decode"][0],
          "decode_kernel_bound_ms": dec_bound,
          "decode_kernel_bound_share": dec_bound / dec_ms, "card": card})
    return launches, blob, {"encode_wide": enc_s, "decode_wide": dec_s}


def planes_work(n: int) -> tuple:
    """(bytes, operations) of a split or merge of n words: 2 bytes a word
    one way and two 1-byte planes the other; the shifts are not counted
    (the card's bound is its memory)."""
    return 4 * n, 0


def phase_planes(card: str, errs: dict, times: dict) -> dict:
    """The split and merge kernels and the CRC pass without the swap,
    then a 1 GB bf16 block through the card path against the benchmark's
    plain reference.  Returns the kernels' launches on that path."""
    import zlib

    from bench_torch import check
    from bench_torch import gen as bench_gen
    from bench_torch.reference import df11 as ref_df11
    from huffman_tpu_torch import api, container
    from huffman_tpu_torch.ops import crc32 as p_crc
    from huffman_tpu_torch.ops import planes as p_planes
    from huffman_tpu_torch.ops.cuda import crc32 as k_crc
    from huffman_tpu_torch.ops.cuda import planes as k_planes
    from huffman_tpu_torch.utils import timing

    dev = torch.device("cuda")
    cases = 0

    def bits(t: torch.Tensor) -> torch.Tensor:
        return t.view(torch.int16)

    def check_planes(name: str, x: torch.Tensor) -> None:
        nonlocal cases
        e, s = k_planes.split_bf16(x)
        pe, ps = p_planes.split_bf16_plain(x)
        require(torch.equal(e, pe) and torch.equal(s, ps),
                f"split {name}: != plain")
        # the merge from planes at byte offsets 0-4, as inside a container
        for off in range(5):
            ve = torch.empty(x.numel() + off, dtype=torch.uint8,
                             device=dev)[off:]
            vs = torch.empty(x.numel() + 4 - off, dtype=torch.uint8,
                             device=dev)[4 - off:]
            ve.copy_(e)
            vs.copy_(s)
            require(torch.equal(bits(k_planes.merge_bf16(ve, vs)), bits(x)),
                    f"merge {name} planes at offsets {off}, {4 - off}: "
                    f"!= input")
        require(torch.equal(bits(p_planes.merge_bf16_plain(e, s)), bits(x)),
                f"plain merge {name}: != input")
        cases += 1

    rng = np.random.default_rng(21)
    every = torch.arange(1 << 16, dtype=torch.int32, device=dev)
    every = (every - (every >> 15 << 16)).to(torch.int16).view(torch.bfloat16)
    check_planes("every_word", every)
    for n in (0, 1, 7, 8, 9, 15, 16, 17, 4097, (1 << 20) + 3):
        words = torch.from_numpy(rng.integers(-2**15, 2**15, n + 8,
                                              dtype=np.int16)).to(dev)
        for off in range(9) if n <= 4097 else (0, 1, 5):
            check_planes(f"n{n}_word_offset{off}",
                         words[off: off + n].view(torch.bfloat16))
    errs["planes"] = 0

    for w in (0, 1, 1023, 1025, 1024 * 1024 + 3):
        words = rng.integers(0, 2**32, w, dtype=np.uint64).astype(np.uint32)
        src = torch.from_numpy(words.view(np.int32)).to(dev)
        head = bytes(range(37))
        start = torch.tensor([zlib.crc32(head)], dtype=torch.int64).to(
            torch.int32).to(dev)
        for with_start in (False, True):
            want = zlib.crc32(words.tobytes(),
                              zlib.crc32(head) if with_start else 0)
            for copy in (False, True):
                dst = torch.zeros_like(src) if copy else None
                crc = torch.empty(1, dtype=torch.int32, device=dev)
                k_crc.copy_crc32(src, dst, crc, start if with_start else None)
                got = int(crc.cpu().numpy().view(np.uint32)[0])
                plain_crc = torch.empty_like(crc)
                p_crc.copy_crc32_plain(src, None, plain_crc,
                                       start if with_start else None)
                require(got == want == int(plain_crc.cpu().numpy().view(
                    np.uint32)[0]), f"copy_crc32 {w} words: {got:#x} != "
                    f"zlib {want:#x}")
                require(dst is None or torch.equal(dst, src),
                        f"copy_crc32 {w} words: copy != source")

    # one Nemotron-H-47B MLP block, drawn as the benchmark's traffic draws
    # it, through the card path
    traffic = json.load(open(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "bench_torch", "traffic",
        "nemotron-h-47b-mlp-bf16.json")))
    config = json.load(open(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "bench_torch", "configs",
        "df11-bf16-device.json")))
    raw = bench_gen.generate(traffic, 1, dev)
    x = raw.view(torch.bfloat16)
    n = x.numel()
    e, s = k_planes.split_bf16(x)
    ms = {}
    for name, m in (("main", n), ("sixteenth", n // 16)):
        xs, es, ss = x[:m], e[:m], s[:m]
        ms[name] = {"split": graph_ms(lambda: k_planes.split_bf16(xs), 5),
                    "merge": graph_ms(lambda: k_planes.merge_bf16(es, ss),
                                      5)}
    plain_ms = cuda_ms(lambda: p_planes.split_bf16_plain(x[: n // 16]), 1)
    times["planes"] = (ms["sixteenth"]["split"], plain_ms,
                       planes_work(n // 16))
    bound_ms = bound(planes_work(n))[0]
    del e, s

    counters = {"split": k_planes.launches, "merge": k_planes.merge_launches,
                "crc32": k_crc.launches, "copy_crc32": k_crc.copy_launches}
    kernels, plain = path_counters()
    counters.update({k: kernels[k] for k in ("encode", "pack", "histogram",
                                             "scan", "dense_decode")})
    plain_counters = {**plain, "planes": p_planes.cuda_calls,
                      "crc32": p_crc.cuda_calls}
    for c in [*counters.values(), *plain_counters.values()]:
        c.n = 0
    before = {k: c.n for k, c in timing.copied.items()}
    walls = {}

    def stage(name, fn):
        got, walls[name] = wall(fn)
        return got

    enc, trace = stage("encode", lambda: api.encode_traced(x, device="cuda"))
    buf = stage("dumps", lambda: container.dumps_device(enc))
    back = stage("loads", lambda: container.loads_device(buf))
    y = stage("decode", lambda: api.decode(back, device="cuda"))
    launches = {k: c.n for k, c in counters.items()}
    plain_calls = {k: c.n for k, c in plain_counters.items()}
    moved = sum(c.n - before[k] for k, c in timing.copied.items())
    require(isinstance(enc, api.PlanesEncoded) and y.is_cuda
            and y.dtype == torch.bfloat16, "the planes path left the card")
    require(torch.equal(bits(y), bits(x)), "bf16 roundtrip != input")
    require(not any(plain_calls.values()),
            f"a plain version ran on CUDA tensors: {plain_calls}")
    require(launches["split"] == 1 and launches["merge"] == 1
            and launches["crc32"] == 2 and launches["copy_crc32"] == 2
            and launches["encode"] == len(trace.capacities_tried)
            and launches["dense_decode"] == 1,
            f"planes path launches {launches} for {trace}")
    require(moved < 2 * n / 100, f"{moved} bytes crossed")
    blob = buf.cpu().numpy().tobytes()
    del enc, back, y, buf
    torch.cuda.empty_cache()
    sections, size, work = ref_df11.expect(raw, config)
    mismatches = check.container_mismatches(blob, sections, size)
    require(sum(mismatches.values()) == 0,
            f"v4 container != reference: {mismatches}")
    gb = 2 * n / 1e9
    rec = {"phase": "planes", "cases": cases, "elements": n,
           "planes_ms": ms, "planes_bytes": planes_work(n)[0],
           "planes_bound_ms": bound_ms,
           "planes_bound_share": {k: bound_ms / v
                                  for k, v in ms["main"].items()},
           "plain_split_ms_sixteenth": plain_ms,
           "container_equal_reference": True, "roundtrip_exact": True,
           "stored_bits_per_byte": 8 * len(blob) / (2 * n),
           "exponent_bits_per_byte": 8 * work["stream_words"] * 4 / n,
           "distinct_exponents": int(np.count_nonzero(np.frombuffer(
               blob, np.uint8, 256, 40))),
           "sampled": trace.sampled, "rebuilt": trace.rebuilt,
           "capacities_tried": trace.capacities_tried,
           "launches": launches, "bytes_crossed": moved,
           "bytes_crossed_share": moved / (2 * n), "walls_s": walls,
           "encode_GBps": gb / (walls["encode"] + walls["dumps"]),
           "decode_GBps": gb / (walls["loads"] + walls["decode"]),
           "card": card}
    emit(rec)
    del x, raw, blob, sections
    torch.cuda.empty_cache()
    return launches


def wall(fn):
    """fn's result and its host wall in seconds, the device synchronized
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def path_counters() -> tuple[dict, dict]:
    """Every kernel's launch count, and every plain version's count of calls
    on CUDA tensors, by name."""
    from huffman_tpu_torch.ops import decode as p_decode
    from huffman_tpu_torch.ops import encode as p_encode
    from huffman_tpu_torch.ops import histogram as p_hist
    from huffman_tpu_torch.ops import pack as p_pack
    from huffman_tpu_torch.ops import scan as p_scan
    from huffman_tpu_torch.ops import wide as p_wide
    from huffman_tpu_torch.ops.cuda import dense_decode as k_decode
    from huffman_tpu_torch.ops.cuda import encode as k_encode
    from huffman_tpu_torch.ops.cuda import histogram as k_hist
    from huffman_tpu_torch.ops.cuda import pack2 as k_pack
    from huffman_tpu_torch.ops.cuda import scan as k_scan
    from huffman_tpu_torch.ops.cuda import wide_decode as k_wdec
    from huffman_tpu_torch.ops.cuda import wide_emit as k_emit
    from huffman_tpu_torch.ops.cuda import wide_encode as k_sub
    kernels = {"encode": k_encode.launches, "pack": k_pack.launches,
               "dense_decode": k_decode.launches,
               "wide_sub_encode": k_sub.launches,
               "wide_schedule": k_emit.schedule_launches,
               "wide_emit": k_emit.launches, "wide_decode": k_wdec.launches,
               "histogram": k_hist.launches, "scan": k_scan.launches}
    plain = {"encode": p_encode.cuda_calls, "pack": p_pack.cuda_calls,
             "dense_decode": p_decode.cuda_calls,
             "histogram": p_hist.cuda_calls, "scan": p_scan.cuda_calls,
             **{f"wide_{k}": c for k, c in p_wide.cuda_calls.items()}}
    return kernels, plain


def phase_sharded(card: str, data: np.ndarray, exact, wide_blob: bytes,
                  single_walls: dict) -> dict:
    """The sharded codec on the main input.  Its histogram is exact, so its
    codebook must be the exact one, and its dense stream and container
    those of api.encode under that codebook (api.encode's own may come
    from a sample that held)."""
    from huffman_tpu_torch import api, container
    from huffman_tpu_torch.parallel.mesh import make_mesh
    from huffman_tpu_torch.parallel.pipeline import ShardedCodec

    codec = ShardedCodec(make_mesh(devices=["cuda:0"] * SHARDS))
    kernels, plain = path_counters()
    walls = {}

    # --- the sharded path, with every count at 0 just before it ---
    for c in (*kernels.values(), *plain.values()):
        c.n = 0
    enc, walls["encode"] = wall(lambda: codec.encode(data))
    encode_hist, encode_scan = kernels["histogram"].n, kernels["scan"].n
    blob = container.dumps(enc)
    enc2 = container.loads(blob)
    back, walls["decode"] = wall(lambda: codec.decode(enc2))
    decode_scan = kernels["scan"].n - encode_scan
    wenc, walls["encode_wide"] = wall(lambda: codec.encode_wide(data))
    encode_wide_scan = kernels["scan"].n - encode_scan - decode_scan
    wblob = container.dumps_wide(wenc)
    wenc2 = container.loads_wide(wblob)
    wback, walls["decode_wide"] = wall(lambda: codec.decode_wide(wenc2))
    launches = {k: c.n for k, c in kernels.items()}
    plain_calls = {k: c.n for k, c in plain.items()}
    # --- end of the sharded path ---

    require(all(v >= SHARDS for v in launches.values()),
            f"a kernel ran on fewer than {SHARDS} shards: {launches}")
    # one histogram a shard for each of the two encodes
    hist_by_call = {"encode": encode_hist,
                    "encode_wide": launches["histogram"] - encode_hist}
    require(hist_by_call == {"encode": SHARDS, "encode_wide": SHARDS},
            f"sharded histogram launches {hist_by_call}")
    # one offset scan a shard in each encode (the packs' offsets, the
    # payload offsets); the decodes take their offsets from the host
    scan_by_call = {"encode": encode_scan, "decode": decode_scan,
                    "encode_wide": encode_wide_scan,
                    "decode_wide": launches["scan"] - encode_scan
                    - decode_scan - encode_wide_scan}
    require(scan_by_call == {"encode": SHARDS, "decode": 0,
                             "encode_wide": SHARDS, "decode_wide": 0},
            f"sharded scan launches {scan_by_call}")
    require(not any(plain_calls.values()),
            f"a plain version ran on CUDA tensors: {plain_calls}")
    require(np.array_equal(enc.codebook.lengths, exact.lengths),
            "sharded codebook != exact codebook")
    single = api.encode(data, codebook=enc.codebook, device="cuda")
    require(enc.total_bits == single.total_bits,
            f"sharded total_bits {enc.total_bits} != {single.total_bits}")
    require(np.array_equal(enc.stream_words, single.stream_words),
            "sharded stream words != single-device stream")
    require(blob == container.dumps(single),
            "sharded container != single-device container")
    del single
    require(np.array_equal(back, data), "sharded decode != input")
    require(wblob == wide_blob,
            "sharded wide container != single-device wide container")
    require(np.array_equal(wback, data), "sharded wide decode != input")
    del enc2, back, wenc, wenc2, wback, blob, wblob
    emit({"phase": "sharded", "bytes": int(data.size), "shards": SHARDS,
          "devices": [str(d) for d in codec.mesh.devices],
          "codebook_exact": True,
          "stream_equal_single_same_book": True,
          "container_equal_single_same_book": True,
          "wide_container_equal_single": True, "roundtrips_exact": True,
          "launches": launches, "plain_calls_on_cuda": plain_calls,
          "histogram_launches_by_call": hist_by_call,
          "scan_launches_by_call": scan_by_call,
          "wall_s": walls, "single_device_wall_s": single_walls,
          "GBps": {k: data.size / 1e9 / v for k, v in walls.items()},
          "card": card})
    return launches


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_multiprocess(card: str) -> None:
    """Start MP_WORKERS copies of this script as one process group and
    require an OK line from each."""
    port = free_port()
    t0 = time.perf_counter()
    logs = [tempfile.TemporaryFile("w+") for _ in range(MP_WORKERS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(rank),
         str(MP_WORKERS), str(port)], stdout=log, stderr=subprocess.STDOUT,
        text=True) for rank, log in enumerate(logs)]
    try:
        # a worker that fails leaves the other waiting in a collective:
        # stop both at the first failure, or at the time limit
        while any(p.poll() is None for p in procs):
            if (any(p.poll() for p in procs)
                    or time.perf_counter() - t0 > MP_TIMEOUT_S):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    records = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        require(p.returncode == 0,
                f"worker {rank} exited {p.returncode}:\n{out[-4000:]}")
        ok = [ln for ln in out.splitlines() if ln.startswith(MP_OK)]
        require(ok, f"worker {rank} printed no OK line:\n{out[-4000:]}")
        records.append(json.loads(ok[-1][len(MP_OK):]))
    emit({"phase": "multiprocess", "workers": records,
          "seconds": time.perf_counter() - t0, "card": card})


def worker(rank: int, world: int, port: int) -> int:
    """One process of the multiprocess phase: two shards of cuda:0 in a
    mesh of 2 * world over gloo."""
    from huffman_tpu_torch import api, container, wide
    from huffman_tpu_torch.parallel.mesh import init_multihost, make_mesh
    from huffman_tpu_torch.parallel.pipeline import ShardedCodec
    from huffman_tpu_torch.utils import testdata

    init_multihost(f"localhost:{port}", world, rank)
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    require(mesh.size == 2 * world and
            mesh.local_shards == [2 * rank, 2 * rank + 1], f"mesh {mesh}")
    data = testdata.entropy_stream(MP_BYTES, seed=0)
    codec = ShardedCodec(mesh)
    kernels, plain = path_counters()
    for c in (*kernels.values(), *plain.values()):
        c.n = 0
    enc, enc_s = wall(lambda: codec.encode(data))
    back, dec_s = wall(lambda: codec.decode(enc))
    wenc, wenc_s = wall(lambda: codec.encode_wide(data))
    wback, wdec_s = wall(lambda: codec.decode_wide(wenc))
    launches = {k: c.n for k, c in kernels.items()}
    require(all(v >= 2 for v in launches.values()),
            f"a kernel ran on fewer than 2 shards: {launches}")
    require(not any(c.n for c in plain.values()),
            "a plain version ran on CUDA tensors")
    require(np.array_equal(enc.codebook.lengths, api.build_codebook(
        data, device="cuda").lengths), "sharded codebook != exact codebook")
    single = api.encode(data, codebook=enc.codebook, device="cuda")
    require(enc.total_bits == single.total_bits and
            np.array_equal(enc.stream_words, single.stream_words),
            "sharded stream != single-device stream under its codebook")
    require(container.dumps(enc) == container.dumps(single),
            "sharded container != single-device container")
    require(np.array_equal(back, data), "sharded decode != input")
    require(container.dumps_wide(wenc) == container.dumps_wide(
        wide.encode_wide(data, device="cuda")),
        "sharded wide container != single-device wide container")
    require(np.array_equal(wback, data), "sharded wide decode != input")
    torch.distributed.destroy_process_group()
    print(MP_OK + json.dumps({
        "rank": rank, "world": world, "shards": mesh.size,
        "local_shards": mesh.local_shards, "bytes": int(data.size),
        "launches": launches, "wall_s": {
            "encode": enc_s, "decode": dec_s, "encode_wide": wenc_s,
            "decode_wide": wdec_s}}), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from huffman_tpu_torch.ops.cuda import _build
    from huffman_tpu_torch.ops.cuda import crc32 as k_crc
    from huffman_tpu_torch.ops.cuda import dense_decode as k_decode
    from huffman_tpu_torch.ops.cuda import encode as k_encode
    from huffman_tpu_torch.ops.cuda import histogram as k_hist
    from huffman_tpu_torch.ops.cuda import pack2 as k_pack
    from huffman_tpu_torch.ops.cuda import planes as k_planes
    from huffman_tpu_torch.ops.cuda import scan as k_scan
    from huffman_tpu_torch.ops.cuda import wide_decode as k_wdec
    from huffman_tpu_torch.ops.cuda import wide_emit as k_emit
    from huffman_tpu_torch.ops.cuda import wide_encode as k_sub
    from huffman_tpu_torch.utils import testdata

    card = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    log = _build.build()
    _build.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]})

    errs: dict = {}
    times: dict = {}
    library: dict = {}
    phase_kernels(card, errs, times, library)
    phase_wide_kernels(card, errs, times)
    t0 = time.perf_counter()
    data = testdata.entropy_stream(MAIN_BYTES, seed=0)
    emit({"phase": "datagen", "bytes": MAIN_BYTES,
          "seconds": time.perf_counter() - t0})
    launches, single, exact, walls = phase_main(card, data)
    launches["crc32"] = phase_device(card, data, single, errs,
                                     times)["crc32"]
    plane_launches = phase_planes(card, errs, times)
    launches["planes"] = plane_launches["split"] + plane_launches["merge"]
    wide_launches, wide_blob, wide_walls = phase_wide_main(
        card, data, single.total_bits)
    # each kernel's launches on the two main paths (the histogram and the
    # scan run on both)
    launches = {k: launches.get(k, 0) + wide_launches.get(k, 0)
                for k in {*launches, *wide_launches}}
    walls.update(wide_walls)
    del single
    phase_sharded(card, data, exact, wide_blob, walls)
    del data, wide_blob
    torch.cuda.empty_cache()
    phase_multiprocess(card)

    # wide_emit's launches count its emit kernel; the schedule kernel, its
    # first pass, is checked in the wide_main record
    mods = {"encode": k_encode, "pack": k_pack, "dense_decode": k_decode,
            "wide_sub_encode": k_sub, "wide_emit": k_emit,
            "wide_decode": k_wdec, "histogram": k_hist, "scan": k_scan,
            "crc32": k_crc, "planes": k_planes}
    # times at the kernel cases' main-path shapes (64 MiB); library_ms is
    # torch.bincount's for the histogram, the torch.cumsum chain's (the
    # plain version, by graph replay) for the scan, and null for the
    # others: no PyTorch call computes a Huffman encode, pack or decode
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": m.SOURCE,
         "replaces": m.REPLACES, "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bytes": times[name][2][0],
         "operations": times[name][2][1],
         "bound_ms": bound(times[name][2])[0],
         "bound_by": bound(times[name][2])[1],
         "library_ms": library.get(name)}
        for name, m in mods.items()]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--worker":
        if not torch.cuda.is_available():
            sys.exit(2)
        sys.exit(worker(*map(int, sys.argv[2:])))
    sys.exit(main())
