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

// OR the bits of v (left-aligned: bit 63 goes first) into buf at bit `pos`.
// Words at or past `cap` are dropped.  Every shift stays within [0, 63].
__device__ __forceinline__ void put_bits(uint32_t* buf, uint32_t cap,
                                         uint32_t pos, uint64_t v) {
  const uint32_t w = pos >> 5, o = pos & 31;
  const uint32_t a = (uint32_t)(v >> (32 + o));
  const uint32_t b = (uint32_t)(v >> o);
  const uint32_t c = o ? (uint32_t)(v << (32 - o)) : 0u;
  if (a && w < cap) atomicOr(&buf[w], a);
  if (b && w + 1 < cap) atomicOr(&buf[w + 1], b);
  if (c && w + 2 < cap) atomicOr(&buf[w + 2], c);
}

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

// Inclusive sum over the lanes of a full warp.
__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
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
// A CTA of ceil(bw / 32) * 32 threads walks the rows blockIdx.x,
// blockIdx.x + gridDim.x, ...; thread t < bw encodes bytes 4t .. 4t + 3 of
// the row, which are the little-endian bytes of input word t.  Each row's
// codes go MSB-first into a shared-memory copy of its cap output words,
// placed by a CTA-wide exclusive scan of the per-thread bit counts and
// atomicOr, and stored coalesced once the row is done.  bits_out gets the
// row's bit count, with MISS_FLAG where a valid byte has no code.  With
// ITEM_BITS, item_bits[b * bw + t] also gets thread t's own bit count
// (K5's `l2`; it must fit a byte, which codes of at most 12 bits do).
template <bool ITEM_BITS>
__global__ void encode_rows_kernel(const uint32_t* __restrict__ words,
                                   const uint32_t* __restrict__ codes,
                                   const int32_t* __restrict__ lengths,
                                   const int32_t* __restrict__ valid,
                                   uint32_t* __restrict__ out,
                                   int32_t* __restrict__ bits_out,
                                   uint8_t* __restrict__ item_bits,
                                   long long nb, int bw, int cap) {
  extern __shared__ uint32_t s_out[];      // the row's cap output words
  __shared__ uint32_t s_tab[256];          // (code << 5) | length
  __shared__ uint32_t s_warp[32];          // per-warp sums, then their scan
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  for (int i = t; i < 256; i += blockDim.x)
    s_tab[i] = (codes[i] << 5) | (uint32_t)lengths[i];
  __syncthreads();

  for (long long b = blockIdx.x; b < nb; b += gridDim.x) {
    for (int i = t; i < cap; i += blockDim.x) s_out[i] = 0u;
    const int nvalid = valid[b];
    const uint32_t w = t < bw ? words[b * bw + t] : 0u;
    uint32_t lens[4], cds[4], total = 0;
    bool miss = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t e = s_tab[(w >> (8 * k)) & 255u];
      const bool live = t < bw && 4 * t + k < nvalid;
      lens[k] = live ? (e & 31u) : 0u;
      cds[k] = e >> 5;
      miss |= live && lens[k] == 0;
      total += lens[k];
    }
    if (ITEM_BITS && t < bw) item_bits[b * bw + t] = (uint8_t)total;

    // Row-wide exclusive scan of `total`.  The first barrier also makes
    // the zeroed s_out visible before any atomicOr.
    const uint32_t incl = warp_inclusive_scan(total);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const uint32_t x = lane < nwarps ? s_warp[lane] : 0u;
      const uint32_t xi = warp_inclusive_scan(x);
      if (lane < nwarps) s_warp[lane] = xi;
    }
    const int any_miss = __syncthreads_or(miss);
    const uint32_t start = (warp ? s_warp[warp - 1] : 0u) + incl - total;
    const uint32_t row_total = s_warp[nwarps - 1];

    if (total > 0 && total <= 64) {
      // the thread's four codes fit one 64-bit accumulator
      uint64_t acc = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (lens[k]) acc = (acc << lens[k]) | cds[k];
      put_bits(s_out, cap, start, acc << (64 - total));
    } else if (total > 64) {
      // codes longer than 16 bits: place them one at a time
      uint32_t p = start;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (lens[k]) {
          put_bits(s_out, cap, p, (uint64_t)cds[k] << (64 - lens[k]));
          p += lens[k];
        }
      }
    }
    __syncthreads();
    for (int i = t; i < cap; i += blockDim.x) out[b * cap + i] = s_out[i];
    if (t == 0)
      bits_out[b] = (int32_t)(row_total | (any_miss ? MISS_FLAG : 0u));
    __syncthreads();    // s_out and s_warp are reused by the next row
  }
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

// Launch encode_rows_kernel with `cap` words of dynamic shared memory.
template <bool ITEM_BITS>
int launch_encode_rows(const void* words, const void* codes,
                       const void* lengths, const void* valid, void* out,
                       void* bits, void* item_bits, long long nb, int bw,
                       int cap, int grid, void* stream) {
  const int threads = (bw + 31) / 32 * 32;
  const size_t smem = (size_t)cap * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        encode_rows_kernel<ITEM_BITS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  encode_rows_kernel<ITEM_BITS><<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const uint32_t*)codes, (const int32_t*)lengths,
      (const int32_t*)valid, (uint32_t*)out, (int32_t*)bits,
      (uint8_t*)item_bits, nb, bw, cap);
  return (int)cudaGetLastError();
}

}  // namespace
