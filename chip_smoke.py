#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (huffman_tpu_torch) on one GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device  - nvidia-smi's name and power limit, torch and CUDA versions.
  2. build   - nvcc builds every kernel of csrc/ for sm_90a; seconds taken
               and the -Xptxas -v register/spill lines.
  3. kernels - each kernel (K1 encode, pack, K4 decode) against its plain
               PyTorch version on the card, exactly: at the main path's
               shapes (64 MiB, 65536 blocks, capacity 256 words) with CUDA
               event times of both; then a uniform 256-symbol input (every
               block exactly at capacity), a 14-bit codebook, a 20-bit one
               (decode table in device memory), pack alone on blocks that
               spill into their neighbours, and small edge cases.
  4. main    - the main path at 1 GiB, 32 symbols at H = 2.2066: api.encode
               bit-exact against the C++ golden encoder, container dumps ->
               loads -> api.decode equal to the input, decode_range over a
               span that crosses blocks; launch counts read around that run;
               end-to-end and kernel-only rates.
Then the kernels line, the card's nvidia-smi line, and the result line.
Any mismatch raises and the script exits non-zero, as it does when no
CUDA device is available.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

MAIN_BYTES = 1 << 30            # the JAX README's spec size
KERNEL_BYTES = 64 << 20         # the kernel comparisons' size


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


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> int:
    require(x.shape == y.shape, f"shapes {tuple(x.shape)} != {tuple(y.shape)}")
    if x.numel() == 0:
        return 0
    return int((x.to(torch.int64) - y.to(torch.int64)).abs().max())


class Stages:
    """The three kernels of the main path next to their plain versions,
    on device-resident inputs prepared once, so that a timed call is the
    wrapper's launch alone."""

    def __init__(self, data: np.ndarray, cfg, codebook=None):
        from huffman_tpu_torch import api
        from huffman_tpu_torch.ops.decode import table_entries
        self.cfg = cfg
        self.blocks, self.valid = api.device_blocks(data, cfg,
                                                     torch.device("cuda"))
        self.cb = codebook or api.build_codebook(data, cfg, device="cuda")
        self.codes = torch.from_numpy(
            self.cb.codes.astype(np.uint32).view(np.int32)).cuda()
        self.lengths = torch.from_numpy(self.cb.lengths.astype(np.int32)).cuda()
        self.tb = max(self.cb.max_len, 1)
        self.table = torch.from_numpy(table_entries(self.cb, self.tb)).cuda()

    def encode(self, mod):
        return mod.encode_blocks(self.blocks, self.codes, self.lengths,
                                 self.valid, self.cfg.capacity_words)

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
                    times: dict | None = None) -> dict:
    """Each kernel against its plain version on the same device inputs;
    every output must match exactly.  Returns the case's JSON record."""
    from huffman_tpu_torch.ops import decode as p_decode
    from huffman_tpu_torch.ops import encode as p_encode
    from huffman_tpu_torch.ops import pack as p_pack
    from huffman_tpu_torch.ops.cuda import dense_decode as k_decode
    from huffman_tpu_torch.ops.cuda import encode as k_encode
    from huffman_tpu_torch.ops.cuda import pack2 as k_pack
    from huffman_tpu_torch.ops.encode import BITS_MASK
    from huffman_tpu_torch.ops.scan import exclusive_bit_offsets

    st = Stages(data, cfg, codebook)
    rec = {"phase": "kernels", "case": name, "bytes": int(data.size),
           "blocks": int(st.blocks.shape[0]),
           "capacity_words": cfg.capacity_words,
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
    o_p = st.decode(p_decode, w_k, offs)
    e_dec = max_abs_err(o_k, o_p)
    require(e_dec == 0, f"{name}: decode kernel != plain (max err {e_dec})")
    back = o_k.reshape(-1)[: data.size].cpu().numpy()
    require(np.array_equal(back, data), f"{name}: decoded bytes != input")
    for k, e in (("encode", e_enc), ("pack", e_pack), ("dense_decode", e_dec)):
        errs[k] = max(errs.get(k, 0), e)
    rec["total_bits"] = int(offs.total_bits)
    rec["max_abs_err"] = {"encode": e_enc, "pack": e_pack,
                          "dense_decode": e_dec}
    if reps:
        t = {
            "encode": (cuda_ms(lambda: st.encode(k_encode), reps),
                       cuda_ms(lambda: st.encode(p_encode), plain_reps)),
            "pack": (
                cuda_ms(lambda: st.pack(k_pack, s_k, bits, offs, n_words), reps),
                cuda_ms(lambda: st.pack(p_pack, s_k, bits, offs, n_words),
                        plain_reps)),
            "dense_decode": (
                cuda_ms(lambda: st.decode(k_decode, w_k, offs), reps),
                cuda_ms(lambda: st.decode(p_decode, w_k, offs), plain_reps)),
        }
        rec["ms"] = {k: {"kernel": v[0], "plain": v[1]} for k, v in t.items()}
        rec["card"] = card
        if times is not None:
            times.update(t)
    return rec


def compare_pack_full(card: str, errs: dict) -> dict:
    """Pack alone on random streams within two words of capacity, at every
    bit phase: each block's shifted last word spills into its neighbour's
    first word, which encoded data at H = 2.2 never does."""
    from huffman_tpu_torch.ops import pack as p_pack
    from huffman_tpu_torch.ops.cuda import pack2 as k_pack
    from huffman_tpu_torch.ops.scan import exclusive_bit_offsets
    from huffman_tpu_torch.utils import testdata

    nb, cap = 65536, 256
    bits_np = np.random.default_rng(4).integers(cap * 32 - 64, cap * 32 + 1,
                                                size=nb)
    streams = torch.from_numpy(testdata.random_block_streams(bits_np, cap, 4)
                               .view(np.int32)).cuda()
    bits = torch.from_numpy(bits_np.astype(np.int32)).cuda()
    offs = exclusive_bit_offsets(bits)
    n_words = int(offs.total_words)
    e = max_abs_err(Stages.pack(k_pack, streams, bits, offs, n_words),
                    Stages.pack(p_pack, streams, bits, offs, n_words))
    require(e == 0, f"pack_full_blocks: pack kernel != plain (max err {e})")
    errs["pack"] = max(errs.get("pack", 0), e)
    return {"phase": "kernels", "case": "pack_full_blocks", "blocks": nb,
            "capacity_words": cap, "total_bits": int(offs.total_bits),
            "max_abs_err": {"pack": e}, "card": card}


def edge_data():
    """Small explicit-codebook cases: 64-byte blocks (a partial warp of 16
    threads), a final partial block, a 4-byte group that is exactly 32
    bits, and groups of four 24-bit codes (96 bits per thread)."""
    from huffman_tpu_torch.codebook import Codebook
    lens = np.zeros(256, np.int32)
    lens[:25] = list(range(1, 25)) + [24]          # Kraft sum exactly 1
    cb = Codebook.from_lengths(lens)
    rng = np.random.default_rng(7)
    data = np.zeros(64 * 300 + 37, np.uint8)
    data[rng.integers(0, data.size, 2000)] = rng.integers(1, 25, 2000)
    data[64:68] = 7                                 # four 8-bit codes
    data[128:132] = 24                              # four 24-bit codes
    data[200:208] = 23
    return data, cb


def phase_kernels(card: str, errs: dict, times: dict) -> None:
    from huffman_tpu_torch.codebook import Codebook
    from huffman_tpu_torch.config import CodecConfig
    from huffman_tpu_torch.utils import testdata

    cfg = CodecConfig()
    main = testdata.entropy_stream(KERNEL_BYTES, seed=1)
    emit(compare_kernels("main_path_shapes", main, cfg, card, errs,
                         reps=20, plain_reps=2, times=times))

    uni = testdata.uniform_random(16 << 20, seed=2)
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

    data, cb = edge_data()
    emit(compare_kernels("edges_bb64_24bit", data,
                         CodecConfig(block_bytes=64, max_code_len=24,
                                     capacity_bits_per_byte=24),
                         card, errs, codebook=cb))


def phase_main(card: str) -> dict:
    from huffman_tpu_torch import api, container, golden
    from huffman_tpu_torch.golden.numpy_codec import packed_bytes_to_words
    from huffman_tpu_torch.ops import decode as p_decode
    from huffman_tpu_torch.ops import encode as p_encode
    from huffman_tpu_torch.ops import pack as p_pack
    from huffman_tpu_torch.ops.cuda import dense_decode as k_decode
    from huffman_tpu_torch.ops.cuda import encode as k_encode
    from huffman_tpu_torch.ops.cuda import pack2 as k_pack
    from huffman_tpu_torch.utils import testdata

    t0 = time.perf_counter()
    data = testdata.entropy_stream(MAIN_BYTES, seed=0)
    gen_s = time.perf_counter() - t0
    counters = [k_encode.launches, k_pack.launches, k_decode.launches,
                p_encode.cuda_calls, p_pack.cuda_calls, p_decode.cuda_calls]

    # --- the main path, with every count at 0 just before it ---
    for c in counters:
        c.n = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = api.encode(data, device="cuda")
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    blob = container.dumps(enc)
    enc2 = container.loads(blob)
    t0 = time.perf_counter()
    back = api.decode(enc2, device="cuda")
    dec_s = time.perf_counter() - t0
    r0, r1 = 3 * 1024 + 100, 9 * 1024 + 333
    part = api.decode_range(enc2, r0, r1, device="cuda")
    torch.cuda.synchronize()
    launches = {"encode": k_encode.launches.n, "pack": k_pack.launches.n,
                "dense_decode": k_decode.launches.n}
    plain_calls = {"encode": p_encode.cuda_calls.n,
                   "pack": p_pack.cuda_calls.n,
                   "dense_decode": p_decode.cuda_calls.n}
    # --- end of the main path ---

    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path never launched: {launches}")
    require(not any(plain_calls.values()),
            f"a plain version ran on CUDA tensors: {plain_calls}")
    t0 = time.perf_counter()
    ref_bytes, ref_bits = golden.encode(data, enc.codebook)
    golden_s = time.perf_counter() - t0
    require(enc.total_bits == ref_bits,
            f"total_bits {enc.total_bits} != golden {ref_bits}")
    require(np.array_equal(enc.stream_words, packed_bytes_to_words(ref_bytes)),
            "stream words != golden encoder")
    require(np.array_equal(back, data), "container roundtrip != input")
    require(np.array_equal(part, data[r0:r1]), "decode_range != input")

    # kernel-only rates on device-resident data at the same size: encode
    # is K1 + offset scan + pack, decode is K4
    from huffman_tpu_torch.config import CodecConfig
    from huffman_tpu_torch.ops.encode import BITS_MASK
    from huffman_tpu_torch.ops.scan import exclusive_bit_offsets
    st = Stages(data, CodecConfig(), enc.codebook)
    n_words = enc.stream_words.size

    def enc_kernels():
        s, b = st.encode(k_encode)
        b = b & BITS_MASK
        return st.pack(k_pack, s, b, exclusive_bit_offsets(b), n_words)

    w_k = enc_kernels()
    offs = exclusive_bit_offsets(
        torch.from_numpy(enc.block_bits).cuda())
    require(np.array_equal(w_k.cpu().numpy().view(np.uint32),
                           enc.stream_words), "device-resident encode != api")
    enc_ms = cuda_ms(enc_kernels, 5)
    dec_ms = cuda_ms(lambda: st.decode(k_decode, w_k, offs), 5)
    gb = data.size / 1e9
    emit({"phase": "main", "bytes": int(data.size), "blocks": len(enc.block_bits),
          "total_bits": enc.total_bits, "bits_per_byte": enc.total_bits / data.size,
          "codebook_max_len": enc.codebook.max_len,
          "golden_bit_exact": True, "roundtrip_exact": True,
          "decode_range": [r0, r1], "decode_range_exact": True,
          "launches": launches, "plain_calls_on_cuda": plain_calls,
          "datagen_s": gen_s, "golden_encode_s": golden_s,
          "encode_e2e_s": enc_s, "decode_e2e_s": dec_s,
          "encode_e2e_GBps": gb / enc_s, "decode_e2e_GBps": gb / dec_s,
          "encode_kernels_ms": enc_ms, "decode_kernel_ms": dec_ms,
          "encode_kernels_GBps": gb / (enc_ms / 1e3),
          "decode_kernel_GBps": gb / (dec_ms / 1e3),
          "card": card})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from huffman_tpu_torch.ops.cuda import _build
    from huffman_tpu_torch.ops.cuda import dense_decode as k_decode
    from huffman_tpu_torch.ops.cuda import encode as k_encode
    from huffman_tpu_torch.ops.cuda import pack2 as k_pack

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
    phase_kernels(card, errs, times)
    launches = phase_main(card)

    mods = {"encode": k_encode, "pack": k_pack, "dense_decode": k_decode}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": m.SOURCE,
         "replaces": m.REPLACES, "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name, m in mods.items()]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
