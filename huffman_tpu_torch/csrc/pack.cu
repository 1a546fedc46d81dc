// K2 + K3: dense pack for Hopper (sm_90a), one kernel.
//
// Replaces huffman_tpu/ops/pallas/pack2.py preshift_rows_pallas (K2,
// _preshift_kernel) and pack_tiles_pallas (K3, _pack_kernel).  The TPU
// pair first shifts every block stream to its global bit phase, then builds
// each 1024-word output tile as the OR of the word-rotated segments that
// cover it, driven by a host plan (plan_pack) and SMEM meta windows: Mosaic
// has no scatter and no atomics.  Here one warp owns one block.  Lane j
// computes destination word j of the block from source words j-1 and j at
// the block's bit phase.  A word that only this block writes is a plain
// store; the block's first and last words may be shared with its neighbours
// and are atomicOr'ed into the zeroed output.  The offsets are an int64
// device cumsum (ops/scan.py); there is no host plan.
//
// What bounds it on the card: device memory, one read of each block's live
// source words and one write of the dense stream.

#include "common.cuh"

namespace {

__global__ void pack_blocks_kernel(const uint32_t* __restrict__ streams,
                                   const int32_t* __restrict__ bits,
                                   const int64_t* __restrict__ word_base,
                                   const int32_t* __restrict__ bit_shift,
                                   uint32_t* __restrict__ out, long long nb,
                                   int cap, long long n_out) {
  const int lane = threadIdx.x & 31;
  const long long warps_per_cta = blockDim.x >> 5;
  const long long n_warps = (long long)gridDim.x * warps_per_cta;
  for (long long b = blockIdx.x * warps_per_cta + (threadIdx.x >> 5); b < nb;
       b += n_warps) {
    const int nbits = bits[b];
    if (nbits <= 0) continue;
    const int sh = bit_shift[b];
    const long long base = word_base[b];
    const int n_src = min((nbits + 31) >> 5, cap);   // live source words
    const int n_dst = (sh + nbits + 31) >> 5;       // destination words
    const uint32_t* src = streams + b * cap;
    for (int j = lane; j < n_dst; j += 32) {
      const uint32_t cur = j < n_src ? src[j] : 0u;
      const uint32_t prev = (j >= 1 && j <= n_src) ? src[j - 1] : 0u;
      const uint32_t v = sh ? (cur >> sh) | (prev << (32 - sh)) : cur;
      const long long d = base + j;
      if (d >= n_out) break;
      if (j == 0 || j == n_dst - 1) {
        if (v) atomicOr(&out[d], v);
      } else {
        out[d] = v;
      }
    }
  }
}

}  // namespace

HUFF_API int huff_pack_blocks(const void* streams, const void* bits,
                              const void* word_base, const void* bit_shift,
                              void* out, long long nb, int cap,
                              long long n_out, int grid, int threads,
                              void* stream) {
  pack_blocks_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)streams, (const int32_t*)bits,
      (const int64_t*)word_base, (const int32_t*)bit_shift, (uint32_t*)out,
      nb, cap, n_out);
  return (int)cudaGetLastError();
}
