// K2 + K3: dense pack for Hopper (sm_90a), one kernel that writes every
// output word once.
//
// Replaces huffman_tpu/ops/pallas/pack2.py preshift_rows_pallas (K2,
// _preshift_kernel) and pack_tiles_pallas (K3, _pack_kernel).  The TPU
// pair first shifts every block stream to its global bit phase, then builds
// each 1024-word output tile as the OR of the word-rotated segments that
// cover it, driven by a host plan (plan_pack) and SMEM meta windows.  Here
// the output is cut into tiles of PACK_TILE words, and each CTA of a
// resident grid walks a run of consecutive tiles, building each one in
// shared memory:
//   1. one warp finds the run's first covering block by a 32-ary search of
//      word_base (the scan's starts are nondecreasing; no host plan); from
//      there the block cursor carries over from tile to tile;
//   2. a thread a block reads the next blocks' bit counts and offsets,
//      coalesced: those that start before the tile's end cover it, and a
//      CTA scan places their live source words in a staging buffer (a batch
//      of blocks at a time, as many as fit);
//   3. the staged words arrive by cp.async, 16 bytes a copy where rows are
//      16-byte aligned;
//   4. a warp a block shifts its words to the block's bit phase into the
//      tile: plain stores for the words that only this block covers, a
//      shared atomicOr for its first and last, which neighbours may share;
//   5. the tile goes out with 16-byte stores, every word once, so the output
//      needs no zero fill and no global atomic.
// Words no block covers (past an overflowed block's live words) are zeros.
// The offsets are an int64 device cumsum (ops/scan.py), and the streams are
// zero past each block's bits, as K1 writes them.
//
// What bounds it on the card: device memory, one read of each block's live
// source words and metadata and one write of the stream; then each tile's
// chain of dependent steps (metadata, the staging round trip, five
// barriers), which the other CTAs of its SM hide only in part.

#include "common.cuh"

namespace {

constexpr int PACK_THREADS = 128;
constexpr int PACK_WARPS = PACK_THREADS / 32;
constexpr int PACK_TILE = 2048;              // output words of a tile
constexpr int PACK_STAGE = PACK_TILE + 256;  // staged source words; holds
                                             // any one block's share
struct PackSlot {     // one covering block of the current batch
  int off;            // its first staged word
  int a0;             // the source word staged there
  int units;          // staged copies (4 words, or 1 without VEC)
  int j0, j1;         // destination words [j0, j1) of the block in the tile
  int n_src, n_dst;   // live source words; destination words of the block
  int sh;             // bit phase
  int rel;            // word_base - tile start
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// The first index of the nondecreasing base[0, n) whose value is >= t (n if
// none), found by one warp in ceil(log32 n) + 1 rounds of 32 loads.
__device__ long long warp_lower_bound(const int64_t* __restrict__ base,
                                      long long n, long long t) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long step = (hi - lo + 31) >> 5;
    const long long p = lo + (lane + 1) * step - 1;
    const bool below = p < hi && __ldg(base + p) < t;
    lo += __popc(__ballot_sync(0xffffffffu, below)) * step;
    hi = min(hi, lo + step - 1);
  }
  return lo;
}

template <bool VEC>
__global__ void __launch_bounds__(PACK_THREADS)
pack_tiles_kernel(const uint32_t* __restrict__ streams,
                  const int32_t* __restrict__ bits,
                  const int64_t* __restrict__ word_base,
                  const int32_t* __restrict__ bit_shift,
                  uint32_t* __restrict__ out, long long nb, int cap,
                  long long n_out) {
  constexpr int U = VEC ? 4 : 1;             // words a staged copy
  __shared__ __align__(16) uint32_t tile[PACK_TILE];
  __shared__ __align__(16) uint32_t stage[PACK_STAGE];
  __shared__ PackSlot slot[PACK_THREADS];
  __shared__ long long s_first;
  __shared__ uint32_t s_warp[PACK_WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this CTA's run of tiles
  const long long n_tiles = (n_out + PACK_TILE - 1) / PACK_TILE;
  const long long tile_a = blockIdx.x * n_tiles / gridDim.x;
  const long long tile_z = (blockIdx.x + 1) * n_tiles / gridDim.x;

  // 1. the first covering block of the run: the last one that starts
  // before it
  if (warp == 0) {
    const long long b = warp_lower_bound(word_base, nb, tile_a * PACK_TILE);
    if (lane == 0) s_first = b;
  }
  for (int i = 4 * tid; i < PACK_TILE; i += 4 * PACK_THREADS)
    *reinterpret_cast<uint4*>(tile + i) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  long long b = max(s_first - 1, 0LL);

  for (long long t = tile_a; t < tile_z; ++t) {
    const long long t0 = t * PACK_TILE;
    const int tw = (int)min((long long)PACK_TILE, n_out - t0);
    const long long t1 = t0 + tw;
    for (;;) {
      // 2. this thread's block, if it starts before t1: its share of the
      // tile and of the staging
      const long long bb = b + tid;
      bool covers = false;
      PackSlot s = {};
      if (bb < nb) {
        const long long nbits = bits[bb];     // three loads in flight
        const long long base = word_base[bb];
        const int sh = bit_shift[bb];
        covers = base < t1;
        if (covers && nbits > 0) {
          s.sh = sh;
          s.n_src = (int)min((nbits + 31) >> 5, (long long)cap);
          s.n_dst = (int)min((sh + nbits + 31) >> 5,
                             (long long)(s.n_src + (sh > 0)));
          const long long lo = max(0LL, t0 - base);
          const long long hi = min((long long)s.n_dst, t1 - base);
          if (lo < hi) {
            s.j0 = (int)lo;
            s.j1 = (int)hi;
            s.rel = (int)(base - t0);
            const int s0 = max(s.j0 - 1, 0), s1 = min(s.j1, s.n_src);
            s.a0 = s0 & -U;
            s.units = (s1 - s.a0 + U - 1) / U;
          }
        }
      }
      // scan of the staged copies (low 16 bits) and covering blocks (high)
      uint32_t incl = warp_inclusive_scan(
          (uint32_t)s.units | (covers ? 1u << 16 : 0u));
      if (lane == 31) s_warp[warp] = incl;
      __syncthreads();
      uint32_t total = 0;
      for (int w = 0; w < PACK_WARPS; ++w) {
        const uint32_t x = s_warp[w];
        total += x;
        if (w < warp) incl += x;
      }
      incl &= 0xffffu;
      s.off = (int)(incl - s.units) * U;
      const int n_cov = (int)(total >> 16);
      // the covering blocks whose words fit (a prefix, at least one block)
      const int n_fit = __syncthreads_count(
          covers && incl * U <= PACK_STAGE);
      if (tid < n_fit) slot[tid] = s;
      __syncthreads();

      // 3. stage the live source words, a warp a block, coalesced
      for (int i = warp; i < n_fit; i += PACK_WARPS) {
        const PackSlot& q = slot[i];
        const uint32_t* src = streams + (b + i) * cap + q.a0;
        for (int u = lane; u < q.units; u += 32) {
          if (VEC) {
            cp_async16(stage + q.off + 4 * u, src + 4 * u, 16);
          } else {
            cp_async4(stage + q.off + u, src + u);
          }
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      // 4. shift each block's words to its phase, into the tile
      for (int i = warp; i < n_fit; i += PACK_WARPS) {
        const PackSlot q = slot[i];
        const int at = q.off - q.a0;         // source word j: stage[at + j]
        // the words between its first and last, which only it covers
        const int hi = min(q.j1, q.n_dst - 1);
        for (int j = max(q.j0, 1) + lane; j < hi; j += 32)
          tile[q.rel + j] = __funnelshift_r(stage[at + j], stage[at + j - 1],
                                            q.sh);
        // its first and last words, which neighbours may share
        const int j = lane ? q.n_dst - 1 : 0;
        if (lane < 2 && j >= q.j0 && j < q.j1 && (lane == 0 || j > 0)) {
          const uint32_t cur = j < q.n_src ? stage[at + j] : 0u;
          const uint32_t prev = j ? stage[at + j - 1] : 0u;
          atomicOr(&tile[q.rel + j], __funnelshift_r(cur, prev, q.sh));
        }
      }
      __syncthreads();
      b += n_fit;
      // done at the first block that starts at or past t1 (or the end)
      if (n_fit == n_cov && n_cov < PACK_THREADS) break;
    }

    // 5. every word of the tile, once, and the tile cleared for the next
    for (int i = 4 * tid; i < tw; i += 4 * PACK_THREADS) {
      uint4* w = reinterpret_cast<uint4*>(tile + i);
      if (i + 4 <= tw) {
        *reinterpret_cast<uint4*>(out + t0 + i) = *w;
      } else {
        for (int k = i; k < tw; ++k) out[t0 + k] = tile[k];
      }
      *w = make_uint4(0u, 0u, 0u, 0u);
    }
    // the next tile starts at the last block that starts before it
    b = max(b - 1, 0LL);
  }
}

}  // namespace

HUFF_API int huff_pack_blocks(const void* streams, const void* bits,
                              const void* word_base, const void* bit_shift,
                              void* out, long long nb, int cap,
                              long long n_out, void* stream) {
  // 16-byte copies need 16-byte aligned rows
  const bool vec = cap % 4 == 0 && (uintptr_t)streams % 16 == 0;
  const auto kernel = vec ? pack_tiles_kernel<true> : pack_tiles_kernel<false>;
  const int grid = resident_grid(kernel, PACK_THREADS, 0,
                                 (n_out + PACK_TILE - 1) / PACK_TILE);
  kernel<<<grid, PACK_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)streams, (const int32_t*)bits,
      (const int64_t*)word_base, (const int32_t*)bit_shift, (uint32_t*)out,
      nb, cap, n_out);
  return (int)cudaGetLastError();
}
