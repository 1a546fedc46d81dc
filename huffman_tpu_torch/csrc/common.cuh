// Shared declarations and device code of the port's CUDA kernels.
//
// Every kernel has a plain C entry point, loaded with ctypes
// (huffman_tpu_torch/ops/cuda/_build.py): pointers and the CUDA stream
// arrive as void*, and the entry returns cudaGetLastError() after the
// launch so that a refused launch is reported where it happened.  Kernels
// allocate nothing; the Python wrappers allocate every buffer.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define HUFF_API extern "C" __attribute__((visibility("default")))

// Stream bit convention: bit i of the stream is bit (31 - (i & 31)) of
// word (i >> 5), i.e. MSB-first 32-bit words.

namespace {

constexpr uint32_t MISS_FLAG = 0x80000000u;

// Asynchronous 16-byte copy from device to shared memory (cp.async, which
// bypasses the registers): `src_bytes` (0..16) bytes are read from src and
// the rest of the 16 are zero-filled.  Both addresses are 16-byte aligned;
// with src_bytes 0 nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy words [w, w + 4) of src (n_words long) into dst with cp_async16;
// words at or past n_words arrive as zeros.
__device__ __forceinline__ void cp_async_words4(uint32_t* dst,
                                                const uint32_t* src,
                                                long long n_words,
                                                long long w) {
  const long long left = n_words - w;
  const int bytes = left >= 4 ? 16 : left > 0 ? (int)left * 4 : 0;
  cp_async16(dst, bytes ? src + w : src, bytes);
}

// CTAs for a grid-stride launch of `kernel` with `threads` and `smem`
// bytes of dynamic shared memory: as many as fit on every SM at once, and
// no more than the `items` CTA-sized pieces of work.
template <typename K>
int resident_grid(K kernel, int threads, size_t smem, long long items) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (int)(items < fit ? (items > 0 ? items : 1) : fit);
}

// buf <<= s for 0 <= s <= 31, as two funnel shifts (no branch on s >= 32).
__device__ __forceinline__ uint64_t shl64(uint64_t buf, int s) {
  const uint32_t hi = (uint32_t)(buf >> 32), lo = (uint32_t)buf;
  return ((uint64_t)__funnelshift_l(lo, hi, s) << 32) | (lo << s);
}

// Inclusive sum over each aligned segment of L lanes of a full warp (L a
// power of two; L = 32 is the whole warp).
template <int L = 32>
__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t x) {
  const int li = threadIdx.x & (L - 1);
#pragma unroll
  for (int d = 1; d < L; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, d, L);
    if (li >= d) x += y;
  }
  return x;
}

// CTA-wide exclusive count of `flag` in thread order (warp w, lane l is
// thread 32w + l), and the CTA's total in *total.  Every thread of the CTA
// calls it; blockDim.x is a multiple of 32.  s holds 33 words of shared
// memory and may be passed again to the next call: its two barriers order
// each call's writes after the previous call's reads.
__device__ __forceinline__ uint32_t cta_exclusive_count(bool flag,
                                                        uint32_t* s,
                                                        uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const uint32_t ballot = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) s[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const uint32_t x = lane < nwarps ? s[lane] : 0u;
    const uint32_t incl = warp_inclusive_scan(x);
    if (lane < nwarps) s[lane] = incl - x;
    if (lane == 31) s[32] = incl;
  }
  __syncthreads();
  *total = s[32];
  return s[warp] + __popc(ballot & ((1u << lane) - 1u));
}

// The row encoder of K1 (encode.cu) and K5 (wide_encode.cu).
//
// Both encode rows of bytes, each into its own MSB-first stream of `cap`
// words with zeros past its bits, and count each row's bits, with
// MISS_FLAG where a valid byte has no code; K5 also keeps `l2`, the bits of
// every 4-byte item.  On the TPU these are the merge trees of
// huffman_tpu/ops/pallas/encode.py:716 encode_blocks_pallas (K1) and
// huffman_tpu/wide.py:153 _sub_encode_device (K5, the tree stopped at
// 256-byte substreams).
//
// What bounds it on the card: device memory, one read of the rows and one
// write of the cap-word output rows (zeros included) and of l2.  The first
// design, a CTA per row with four barriers a row, ran at 21% (K1) and 27.5%
// (K5) of that bound; its ablations (scripts/ablate_encoders.py on an
// H100) put 40% of its time in the placement behind the barriers, 16% in
// the per-byte valid mask and 6% in the row stores, with the lookups alone
// at a third: latency, not bytes.  So:
//  - a warp encodes a row (K1's 1 KiB blocks) or a group of rows (K5's
//    256-byte substreams, four at a time), with no CTA barrier: each lane
//    takes W consecutive input words of its row, and the row's exclusive
//    scan of the lanes' bit counts is one warp (or segment) scan;
//  - input ahead of use: each warp keeps a ring of ENC_RING groups in
//    shared memory, the next ENC_RING - 1 in flight by cp.async while it
//    encodes;
//  - placement without most atomics: a lane's codes are one contiguous bit
//    run, written from a 64-bit accumulator a whole word at a time (four
//    codes fused where they fit 32 bits); only the words at the run's two
//    ends can hold other lanes' bits, and only they take an atomicOr;
//  - a full row skips the per-byte valid mask;
//  - the warp stores its staged rows, zeros included, as whole 16-byte
//    chunks where the group's words are a multiple of 4, and zeroes the
//    staging as it reads it, ready for the next group.
// What is left (ablations of this design, same script): the lookups with
// the loads take about half of K1's time, the placement chain a quarter,
// the stores next to nothing.  Rows of more than ENC_WARP_MAX_BYTES, or not
// a multiple of 16 bytes, or of more than ENC_WARP_MAX_CAP words go to K1's
// encode_rows_cta (encode.cu), which huff_encode_blocks picks by shape.
constexpr int ENC_WARPS = 4;               // warps per CTA
constexpr int ENC_RING = 3;                // input groups a warp holds
constexpr int ENC_WARP_MAX_BYTES = 1024;   // 32 bytes a lane
constexpr int ENC_WARP_MAX_CAP = 1024;     // staged words a warp holds

// OR v into a staged word that other lanes may also write.
__device__ __forceinline__ void or_word(uint32_t* p, uint32_t v) {
  atomicOr(p, v);
}

// One lane's bit run in its warp's staged row: `n` pending bits in the low
// end of `acc` belong to word `w`; the run's first word is shared with
// earlier lanes when the run starts inside it.  Words at or past `cap` are
// dropped.
struct BitRun {
  uint32_t* s;
  uint64_t acc;
  uint32_t w, cap;
  int n;
  bool shared;

  __device__ __forceinline__ BitRun(uint32_t* stage, uint32_t cap_,
                                    uint32_t pos)
      : s(stage), acc(0), w(pos >> 5), cap(cap_), n(pos & 31),
        shared((pos & 31) != 0) {}

  // Append the low `len` bits of v (len <= 32, v < 2**len).
  __device__ __forceinline__ void push(uint32_t v, int len) {
    acc = (acc << len) | v;
    n += len;
    if (n >= 32) {
      n -= 32;
      const uint32_t word = (uint32_t)(acc >> n);
      if (w < cap) {
        if (shared)
          or_word(s + w, word);
        else
          s[w] = word;
      }
      ++w;
      shared = false;
    }
  }

  // The run's last, partial word, which later lanes may share.
  __device__ __forceinline__ void finish() {
    if (n && w < cap) or_word(s + w, (uint32_t)(acc << (32 - n)));
  }
};

// Look up the 4 W bytes of x: e[i] = (code << 5) | length of byte i, 0 for
// a byte past nvalid (with MASK) or a byte with no code; ib[j] = bits of
// item j.  Returns whether a valid byte has no code.
template <int W, bool MASK>
__device__ __forceinline__ bool lookup_items(const uint32_t* tab,
                                             const uint32_t (&x)[W],
                                             int first_byte, int nvalid,
                                             uint32_t (&e)[4 * W],
                                             uint32_t (&ib)[W]) {
  bool miss = false;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    ib[j] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t t = tab[(x[j] >> (8 * k)) & 255u];
      const bool live = !MASK || first_byte + 4 * j + k < nvalid;
      miss |= live && t == 0;
      e[4 * j + k] = live ? t : 0u;
      ib[j] += e[4 * j + k] & 31u;
    }
  }
  return miss;
}

// Place a lane's codes from bit `pos` of the staged row.
template <int W>
__device__ __forceinline__ void place_codes(uint32_t* stage, uint32_t cap,
                                            uint32_t pos,
                                            const uint32_t (&e)[4 * W],
                                            const uint32_t (&ib)[W]) {
  BitRun run(stage, cap, pos);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint32_t* q = e + 4 * j;
    if (ib[j] <= 32) {                     // the item's four codes fused
      uint32_t f = q[0] >> 5;
#pragma unroll
      for (int k = 1; k < 4; ++k) f = (f << (q[k] & 31u)) | (q[k] >> 5);
      run.push(f, (int)ib[j]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) run.push(q[k] >> 5, (int)(q[k] & 31u));
    }
  }
  run.finish();
}

// A warp encodes groups of G consecutive rows of `in` (bb bytes each, bb a
// multiple of 16 and at most 4 W L bytes; `in` 16-byte aligned), groups
// ENC_WARPS * blockIdx.x + warp, + ENC_WARPS * gridDim.x, ...; lane l takes
// words (l % L) W .. (l % L) W + W - 1 of row l / L of the group, L = 32 / G
// lanes a row.  The group's rows are contiguous in the input and in the
// output, so each is one copy in and one store out.  With ITEM_BITS (K5:
// W == 8), item_bits[b * L W + i] gets item i's bits (codes of at most 12
// bits: they fit a byte).
template <int W, int G, bool ITEM_BITS>
__global__ void __launch_bounds__(32 * ENC_WARPS)
encode_rows_warp(const uint8_t* __restrict__ in,
                 const uint32_t* __restrict__ codes,
                 const int32_t* __restrict__ lengths,
                 const int32_t* __restrict__ valid,
                 uint32_t* __restrict__ out, int32_t* __restrict__ bits_out,
                 uint8_t* __restrict__ item_bits, long long nb, int bb,
                 int cap) {
  static_assert(!ITEM_BITS || W == 8, "l2 is stored as 8 bytes a lane");
  constexpr int L = 32 / G;
  constexpr int SLOT = 32 * W;             // ring words per group
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t s_tab[256];          // (code << 5) | length, or 0
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = lane / L, li = lane % L;   // the lane's row, its place in it
  const int gcap = (G * cap + 3) & ~3;     // staged words per group
  uint32_t* ring = smem + warp * (ENC_RING * SLOT + gcap);
  uint32_t* stage = ring + ENC_RING * SLOT;
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    s_tab[i] = lengths[i] ? (codes[i] << 5) | (uint32_t)lengths[i] : 0u;
  for (int i = lane; i < gcap; i += 32) stage[i] = 0u;
  __syncthreads();

  const long long ng = (nb + G - 1) / G;
  const long long stride = (long long)gridDim.x * ENC_WARPS;
  const long long first = (long long)blockIdx.x * ENC_WARPS + warp;
  // copy group g (if any) into ring slot `to`, as one cp.async group
  auto fetch = [&](long long g, int to) {
    if (g < ng) {
      const int chunks = (int)min((long long)G, nb - g * G) * (bb >> 4);
      for (int c = lane; c < chunks; c += 32)
        cp_async16(ring + to * SLOT + 4 * c, in + g * G * bb + 16 * c, 16);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < ENC_RING - 1; ++k) fetch(first + k * stride, k);
  int nvalid_next = first * G + r < nb ? valid[first * G + r] : 0;

  int slot = 0;
  for (long long g = first; g < ng;
       g += stride, slot = slot == ENC_RING - 1 ? 0 : slot + 1) {
    // the slot read last round takes the group ENC_RING - 1 ahead
    fetch(g + (ENC_RING - 1) * stride, slot ? slot - 1 : ENC_RING - 1);
    cp_async_wait<ENC_RING - 1>();
    __syncwarp();
    const long long b = g * G + r;         // the lane's row
    uint32_t x[W];
    const uint32_t* row = ring + slot * SLOT + r * (bb >> 2) + li * W;
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int j = 0; j < W; j += 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + j);
        x[j] = v.x, x[j + 1] = v.y, x[j + 2] = v.z, x[j + 3] = v.w;
      }
    } else if constexpr (W == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(row);
      x[0] = v.x, x[1] = v.y;
    } else {
      x[0] = row[0];
    }
    const int nvalid = nvalid_next;        // 0 past the last row
    const long long bn = b + stride * G;
    nvalid_next = bn < nb ? valid[bn] : 0;

    uint32_t e[4 * W], ib[W];
    const int fb = 4 * W * li;             // the lane's first byte
    const bool miss = nvalid >= 4 * W * L
                          ? lookup_items<W, false>(s_tab, x, fb, nvalid, e, ib)
                          : lookup_items<W, true>(s_tab, x, fb, nvalid, e, ib);
    uint32_t lane_bits = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) lane_bits += ib[j];
    const uint32_t incl = warp_inclusive_scan<L>(lane_bits);
    const uint32_t misses = __ballot_sync(0xffffffffu, miss);
    place_codes<W>(stage + r * cap, cap, incl - lane_bits, e, ib);
    if constexpr (ITEM_BITS) {
      if (b < nb)
        *reinterpret_cast<uint2*>(item_bits + b * L * W + W * li) =
            make_uint2(ib[0] | ib[1] << 8 | ib[2] << 16 | ib[3] << 24,
                       ib[4] | ib[5] << 8 | ib[6] << 16 | ib[7] << 24);
    }
    __syncwarp();       // the group is staged, and the ring slot read

    // store the group's rows, zeros included, and zero the staging
    const int n = (int)min((long long)G, nb - g * G) * cap;
    uint32_t* orow = out + g * G * cap;
    if (((G * cap) & 3) == 0 && (n & 3) == 0) {
      uint4* s4 = reinterpret_cast<uint4*>(stage);
      for (int c = lane; c < n >> 2; c += 32) {
        const uint4 v = s4[c];
        s4[c] = make_uint4(0u, 0u, 0u, 0u);
        reinterpret_cast<uint4*>(orow)[c] = v;
      }
    } else {
      for (int i = lane; i < n; i += 32) {
        const uint32_t v = stage[i];
        stage[i] = 0u;
        orow[i] = v;
      }
    }
    const uint32_t row_miss = (misses >> (r * L)) & (0xffffffffu >> (32 - L));
    if (li == L - 1 && b < nb)
      bits_out[b] = (int32_t)(incl | (row_miss ? MISS_FLAG : 0u));
  }  // rows
}

template <int W, int G, bool ITEM_BITS>
int launch_rows_warp(const void* in, const void* codes, const void* lengths,
                     const void* valid, void* out, void* bits,
                     void* item_bits, long long nb, int bb, int cap,
                     cudaStream_t s) {
  auto kernel = encode_rows_warp<W, G, ITEM_BITS>;
  const size_t smem =
      (size_t)ENC_WARPS * (ENC_RING * 32 * W + ((G * cap + 3) & ~3)) * 4;
  const long long groups = (nb + G - 1) / G;
  const int grid = resident_grid(kernel, 32 * ENC_WARPS, smem,
                                 (groups + ENC_WARPS - 1) / ENC_WARPS);
  kernel<<<grid, 32 * ENC_WARPS, smem, s>>>(
      (const uint8_t*)in, (const uint32_t*)codes, (const int32_t*)lengths,
      (const int32_t*)valid, (uint32_t*)out, (int32_t*)bits,
      (uint8_t*)item_bits, nb, bb, cap);
  return (int)cudaGetLastError();
}

// The wide format (spec: huffman_tpu/golden/wide_codec.py).  Tile t's
// substream k is row t * WIDE_N_SUB + k of the (NS, WIDE_SUB_BYTES) input;
// K7 and K8 run one CTA of WIDE_N_SUB threads per tile, thread k for
// substream k.
constexpr int WIDE_N_SUB = 1024;
constexpr int WIDE_SUB_BYTES = 256;
constexpr long long WIDE_TILE_BYTES = (long long)WIDE_N_SUB * WIDE_SUB_BYTES;
constexpr int WIDE_ROUNDS = 64;
constexpr int WIDE_SPR = 4;          // symbols decoded per round
constexpr int WIDE_ITEMS = 64;       // 4-byte items (l2 entries) per row
constexpr int WIDE_THRESH = 48;

// Bytes of substream k in a tile that holds tile_bytes bytes.
__device__ __forceinline__ int wide_substream_valid(int tile_bytes, int k) {
  return min(max(tile_bytes - WIDE_SUB_BYTES * k, 0), WIDE_SUB_BYTES);
}

// The spec's pull rule for round j: symbols left, fewer than THRESH bits
// buffered, and fewer than the remaining symbols could need.
__device__ __forceinline__ bool wide_pulls(int avail, int n_k, int j,
                                           int mcl) {
  const int rem = n_k - WIDE_SPR * j;
  return rem > 0 && avail < WIDE_THRESH && avail < mcl * rem;
}

}  // namespace
