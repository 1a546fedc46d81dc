// Byte histogram for Hopper (sm_90a): the 256-bin count of the first n
// bytes of a device buffer, added into an int64 (256,) output.
//
// Replaces the JAX package's device histogram,
// huffman_tpu/ops/histogram.py histogram_onehot (two 16-wide nibble
// one-hots contracted on the MXU per 32 Ki-element tile, in a lax.scan)
// and its scatter-add baseline histogram_xla.  The TPU has no atomics and
// a matrix unit to spare, so it turns counting into a product; this card
// has shared-memory atomics, and the reference GPU histogram's shape
// (hist.cu:38-51: bins in shared memory, merged by atomicAdd) serves,
// made exact: every byte once, counts past 2^32.
//
// Design:
//   1. A resident grid of HIST_THREADS-thread CTAs walks the 16-byte
//      aligned body in a grid-stride loop, HIST_UNROLL 16-byte loads a lane
//      in flight, each warp reading 512 contiguous bytes a load.
//   2. Each warp counts into its own 256 32-bit bins in shared memory, one
//      shared atomicAdd a byte.  The card combines the lanes of one
//      instruction that add to the same word, so the main profile's hot
//      byte (~45% of the input) and a run of one byte cost no more than
//      spread bytes: lanes that hit different words of one bank are what
//      serializes (uniform bytes, ~3.5 ways).  Combining lanes first
//      (__match_any_sync), 8-bit counters private to each thread, and one
//      copy of the bins a CTA are slower or no faster here
//      (scripts/ablate_hist.py).
//   3. At the end each CTA sums its warps' bins and adds the 256 sums to
//      the output with 64-bit atomicAdd.
//   4. The unaligned head before the first 16-byte boundary and the tail
//      after the last whole vector (at most 15 bytes each) are counted by
//      the first CTA's first warp with one 64-bit atomicAdd a byte.
// A CTA's 32-bit bins see at most n / grid + 4 KiB bytes, which passes
// 2^32 only for n past grid * 4 GiB (over 500 GB on the 132 SMs of an
// H100, more than the card holds); the entry point refuses such an n, and
// the merge into the output is 64-bit.  Indices are 64-bit.
//
// What bounds it on the card: device memory, one read of the input (the
// output is 2 KiB).  Each byte costs an extract and a shared atomic, a
// fifth of the SM's issue rate at the memory bound; uniform bytes add the
// bank conflicts of their atomics.

#include "common.cuh"

namespace {

constexpr int HIST_THREADS = 128;
constexpr int HIST_WARPS = HIST_THREADS / 32;
constexpr int HIST_UNROLL = 2;                   // 16-byte loads a lane in flight
constexpr int HIST_WORDS = HIST_WARPS * 256;     // the bins' words

// Count the four bytes of x into `bins`.
__device__ __forceinline__ void count_word(uint32_t* bins, uint32_t x) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t b = (x >> (8 * k)) & 255u;
    atomicAdd(bins + b, 1u);
  }
}

__global__ void __launch_bounds__(HIST_THREADS)
    histogram_kernel(const uint4* __restrict__ body, long long nv,
                     const uint8_t* __restrict__ head, int n_head,
                     const uint8_t* __restrict__ tail, int n_tail,
                     unsigned long long* __restrict__ out) {
  __shared__ uint32_t bins[HIST_WORDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < HIST_WORDS; i += HIST_THREADS) bins[i] = 0;
  __syncthreads();
  uint32_t* mine = bins + warp * 256;

  // a warp's loads are HIST_UNROLL runs of 32 vectors
  constexpr long long WARP_SPAN = 32 * HIST_UNROLL;
  const long long stride = (long long)gridDim.x * HIST_THREADS * HIST_UNROLL;
  for (long long v0 = ((long long)blockIdx.x * HIST_WARPS + warp) * WARP_SPAN;
       v0 < nv; v0 += stride) {
    uint4 q[HIST_UNROLL];
#pragma unroll
    for (int u = 0; u < HIST_UNROLL; ++u) {
      const long long v = v0 + u * 32 + lane;
      q[u] = v < nv ? __ldcs(body + v) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < HIST_UNROLL; ++u) {
      if (v0 + u * 32 + lane < nv) {
        count_word(mine, q[u].x);
        count_word(mine, q[u].y);
        count_word(mine, q[u].z);
        count_word(mine, q[u].w);
      }
    }
  }

  // one 64-bit add a bin and CTA
  __syncthreads();
  for (int b = tid; b < 256; b += HIST_THREADS) {
    unsigned long long s = 0;
#pragma unroll
    for (int w = 0; w < HIST_WARPS; ++w) s += bins[w * 256 + b];
    if (s) atomicAdd(out + b, s);
  }
  if (blockIdx.x == 0 && warp == 0) {
    if (lane < n_head) atomicAdd(out + head[lane], 1ull);
    if (lane < n_tail) atomicAdd(out + tail[lane], 1ull);
  }
}

}  // namespace

// Add the 256-bin count of data[0, n) to out (int64, 256).  data may start
// at any address.
HUFF_API int huff_histogram(const void* data, long long n, void* out,
                            void* stream) {
  const uint8_t* p = (const uint8_t*)data;
  const long long lead = (16 - (long long)((uintptr_t)p & 15)) & 15;
  const int n_head = (int)(n < lead ? n : lead);
  const long long nv = (n - n_head) >> 4;
  const int n_tail = (int)((n - n_head) & 15);
  const uint4* body = (const uint4*)(p + n_head);
  const long long per_cta = HIST_THREADS * HIST_UNROLL;
  const int grid = resident_grid(histogram_kernel, HIST_THREADS, 0,
                                 (nv + per_cta - 1) / per_cta);
  // no CTA's 32-bit bins may reach 2^32 bytes
  if (nv / grid + per_cta >= (1ll << 28)) return (int)cudaErrorInvalidValue;
  histogram_kernel<<<grid, HIST_THREADS, 0, (cudaStream_t)stream>>>(
      body, nv, p, n_head, p + n_head + (nv << 4), n_tail,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}
