// Exclusive offset scan for Hopper (sm_90a): where each block's bits (or
// each wide tile's payload words) begin, from the per-item counts.
//
// Replaces the JAX package's offset scan,
// huffman_tpu/ops/scan.py exclusive_bit_offsets (a split-form pair of
// jnp.cumsum that XLA fuses; the sharded copy in parallel/pipeline.py),
// and the int64 torch.cumsum chain the port ran before.  The CUDA
// reference scans with a multi-level kernel (scan.cu:228-231), one
// launch a level; this is one pass.
//
// What it computes, for x an (n,) int32 array of non-negative counts,
// start_bit in 0..31 and scale in {1, 2}: s_i = start_bit + scale *
// sum_{j<i} x_j in int64, and
//   - with `shift` (the dense offsets, scale 1): out[i] = s_i >> 5 (the
//     word where block i begins) and shift[i] = s_i & 31 (its bit in that
//     word, from the MSB);
//   - without (the wide offsets, scale 2, start 0): out[i] = s_i;
//   - totals[0] = s_n, the end bit (or word), and totals[1] =
//     (s_n + 31) >> 5, both int64, left on the device.
//
// What bounds it on the card: device memory, one read of x (4 bytes an
// item) and one write of the outputs (12, or 8 without shift) -- 16.8 MB,
// 5 us, for the 1,048,576 blocks of a 1 GiB input -- and below some
// hundred thousand items, the launch and one chain of dependent steps.
// On an NVIDIA H100 80GB HBM3 at 700.00 W (scripts/ablate_scan.py) the
// kernel takes 8.6 us of device time at 1 GiB, 5.4 us of it without its
// stores: the stores are the larger part, which is why the int64 offsets
// go out through shared memory (stored from registers, 11.8 us).
//
// Design: a single-pass chained scan with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016), so that x is read once and nothing is written twice:
//   1. Each CTA claims the next tile of SCAN_TILE items from a counter, so
//      that a tile's predecessors were all claimed by CTAs already running
//      (forward progress whatever order the card starts CTAs in).
//   2. A warp reads its 512 items as four coalesced 16-byte loads a lane
//      and scans them in registers in int64: one warp scan a load, then
//      the CTA's eight warp totals through shared memory.
//   3. Warp 0 posts the tile's aggregate into its status word, then looks
//      back over 32 predecessors at a time, summing aggregates until it
//      meets an inclusive prefix, and posts its own inclusive prefix.  A
//      status word is 64 bits: a 2-bit flag (none, aggregate, prefix) on
//      top of a 62-bit value, stored and loaded whole at .gpu scope, so
//      flag and value arrive together; with nothing else passed between
//      tiles, relaxed order is enough (scripts/ablate_scan.py's acq_rel
//      variant times release and acquire).
//   4. Every thread writes its items' bit shifts from registers and its
//      int64 offsets through shared memory, each warp's stores 512
//      contiguous bytes an instruction; the last tile writes the totals.
// The status words and the tile counter are cleared on the stream before
// each launch (cudaMemsetAsync, ~2 KiB for a 1 GiB input), in a workspace
// the wrapper allocates per call.  Tagging the flags with a per-call epoch
// instead would need the epoch on the device: a host epoch is frozen into
// a captured CUDA graph, and every replay would read the last one's words.
// Sums are 64-bit from the first add.  Values are clamped at VALUE_CAP
// (2^62 - 1, the status word's value field), and a total that reaches it
// is reported as -1 in both totals: the wrapper raises, nothing wraps.

#include "common.cuh"

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int SCAN_VECS = 4;                          // 16-byte loads a lane
constexpr int WARP_ITEMS = 32 * SCAN_VECS * 4;        // 512
constexpr int SCAN_TILE = SCAN_WARPS * WARP_ITEMS;    // 4096 items a CTA

constexpr unsigned long long FLAG_AGG = 1ull << 62;      // aggregate
constexpr unsigned long long FLAG_PREFIX = 2ull << 62;   // inclusive prefix
constexpr unsigned long long VALUE_CAP = FLAG_AGG - 1;   // the value field

// A status word is read and written whole, coherent across the card
// (.gpu scope).  Relaxed order suffices: the word carries its flag and its
// value together, and no other data passes from tile to tile.
__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// a + b clamped at VALUE_CAP, for a and b at most VALUE_CAP (no wrap)
__device__ __forceinline__ unsigned long long sat_add(unsigned long long a,
                                                      unsigned long long b) {
  const unsigned long long s = a + b;
  return s < VALUE_CAP ? s : VALUE_CAP;
}

__device__ __forceinline__ unsigned long long warp_inclusive_scan64(
    unsigned long long x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Warp 0 of tile `tile` (> 0): post the tile's aggregate, look back until
// an inclusive prefix, post the tile's own.  Returns the tile's exclusive
// prefix in every lane.
__device__ __forceinline__ unsigned long long look_back(
    unsigned long long* status, int tile, unsigned long long agg, int lane) {
  if (lane == 0) store_status(status + tile, FLAG_AGG | agg);
  unsigned long long excl = 0;
  for (long long end = tile - 1;; end -= 32) {
    const long long j = end - lane;                // lane 0: the nearest
    unsigned long long w = FLAG_PREFIX;            // past tile 0: nothing
    if (j >= 0) {
      do {
        w = load_status(status + j);
      } while ((w >> 62) == 0);
    }
    const unsigned prefixes = __ballot_sync(0xffffffffu, (w >> 62) == 2);
    // the window's lanes up to the nearest inclusive prefix
    const int last = prefixes ? __ffs(prefixes) - 1 : 31;
    unsigned long long v = lane <= last ? (w & VALUE_CAP) : 0ull;
#pragma unroll
    for (int d = 16; d; d >>= 1)
      v = sat_add(v, __shfl_xor_sync(0xffffffffu, v, d));
    excl = sat_add(excl, v);
    if (prefixes) break;
  }
  if (lane == 0) store_status(status + tile, FLAG_PREFIX | sat_add(excl, agg));
  return excl;
}

__global__ void __launch_bounds__(SCAN_THREADS)
    bit_offsets_kernel(const int32_t* __restrict__ x, long long n,
                       bool aligned, int start_bit, int scale,
                       long long* __restrict__ out,
                       int32_t* __restrict__ shift,
                       long long* __restrict__ totals,
                       unsigned long long* __restrict__ status,
                       unsigned int* __restrict__ counter) {
  __shared__ __align__(16) unsigned long long s_out[SCAN_TILE];
  __shared__ unsigned long long s_warp[SCAN_WARPS];
  __shared__ unsigned long long s_excl;
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(counter, 1u);
  __syncthreads();
  const int tile = s_tile;
  const long long first =
      (long long)tile * SCAN_TILE + (long long)warp * WARP_ITEMS;

  // load v of a lane holds items first + 4 (32 v + lane) .. + 3: the
  // warp's order is load-major, then lane, then item
  uint32_t q[SCAN_VECS][4];
  unsigned long long pre[SCAN_VECS];
  unsigned long long warp_total = 0;
#pragma unroll
  for (int v = 0; v < SCAN_VECS; ++v) {
    const long long i = first + 4 * (32 * v + lane);
    if (aligned && i + 4 <= n) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(x + i));
      q[v][0] = t.x, q[v][1] = t.y, q[v][2] = t.z, q[v][3] = t.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        q[v][k] = i + k < n ? (uint32_t)x[i + k] : 0u;
    }
    const unsigned long long sum =
        ((unsigned long long)q[v][0] + q[v][1] + q[v][2] + q[v][3]) * scale;
    const unsigned long long incl = warp_inclusive_scan64(sum, lane);
    pre[v] = warp_total + incl - sum;
    warp_total += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) s_warp[warp] = warp_total;
  __syncthreads();

  if (warp == 0) {
    const unsigned long long t = lane < SCAN_WARPS ? s_warp[lane] : 0ull;
    const unsigned long long incl = warp_inclusive_scan64(t, lane);
    if (lane < SCAN_WARPS) s_warp[lane] = incl - t;   // warps' prefixes
    const unsigned long long agg = __shfl_sync(0xffffffffu, incl, 31);
    unsigned long long excl = (unsigned long long)start_bit;
    if (tile == 0) {
      if (lane == 0) store_status(status, FLAG_PREFIX | sat_add(excl, agg));
    } else {
      excl = look_back(status, tile, agg, lane);
    }
    if (lane == 0) {
      s_excl = excl;
      if (tile == (int)gridDim.x - 1) {
        const unsigned long long end = sat_add(excl, agg);
        const bool refused = end == VALUE_CAP;
        totals[0] = refused ? -1ll : (long long)end;
        totals[1] = refused ? -1ll : (long long)((end + 31) >> 5);
      }
    }
  }
  __syncthreads();

  // The outputs (the wrapper's own allocations, 16-byte aligned).  A
  // lane's four bit shifts are 16 contiguous bytes, stored from registers;
  // its four int64 offsets go through the warp's slice of shared memory,
  // so that each store instruction writes 512 contiguous bytes (from
  // registers, a warp's 16-byte stores would land 32 bytes apart, and two
  // instructions would write each sector half and half).
  unsigned long long* slice = s_out + warp * WARP_ITEMS;
  const unsigned long long base = s_excl + s_warp[warp];
#pragma unroll
  for (int v = 0; v < SCAN_VECS; ++v) {
    const long long i = first + 4 * (32 * v + lane);
    unsigned long long s[4], o[4];
    s[0] = base + pre[v];
#pragma unroll
    for (int k = 1; k < 4; ++k)
      s[k] = s[k - 1] + (unsigned long long)q[v][k - 1] * scale;
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = shift ? s[k] >> 5 : s[k];
    if (shift && i + 4 <= n) {
      *reinterpret_cast<int4*>(shift + i) =
          make_int4((int)(s[0] & 31), (int)(s[1] & 31), (int)(s[2] & 31),
                    (int)(s[3] & 31));
    } else if (shift) {
      for (int k = 0; k < 4 && i + k < n; ++k)
        shift[i + k] = (int32_t)(s[k] & 31);
    }
    ulonglong2* to =
        reinterpret_cast<ulonglong2*>(slice + 4 * (32 * v + lane));
    to[0] = make_ulonglong2(o[0], o[1]);
    to[1] = make_ulonglong2(o[2], o[3]);
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < WARP_ITEMS / 64; ++h) {
    const int p = 32 * h + lane;              // items first + 2p, 2p + 1
    const long long i = first + 2 * p;
    const ulonglong2 w = reinterpret_cast<const ulonglong2*>(slice)[p];
    if (i + 2 <= n)
      *reinterpret_cast<ulonglong2*>(out + i) = w;
    else if (i < n)
      out[i] = (long long)w.x;
  }
}

}  // namespace

// The exclusive offsets of x[0, n) from start_bit, each count times scale
// (see above); shift may be null.  work holds ceil(n / SCAN_TILE) + 1
// int64 words, and out and shift are 16-byte aligned.
HUFF_API int huff_bit_offsets(const void* x, long long n, int start_bit,
                              int scale, void* out, void* shift, void* totals,
                              void* work, void* stream) {
  if (n < 1 || start_bit < 0 || start_bit > 31 || scale < 1 || scale > 2)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (n + SCAN_TILE - 1) / SCAN_TILE;
  if (tiles > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* status = (unsigned long long*)work;
  // the tiles' status words and the tile counter after them start at 0
  const cudaError_t e =
      cudaMemsetAsync(work, 0, (size_t)(tiles + 1) * sizeof(*status), s);
  if (e != cudaSuccess) return (int)e;
  const bool aligned = ((uintptr_t)x & 15) == 0;
  bit_offsets_kernel<<<(unsigned)tiles, SCAN_THREADS, 0, s>>>(
      (const int32_t*)x, n, aligned, start_bit, scale, (long long*)out,
      (int32_t*)shift, (long long*)totals, status,
      (unsigned int*)(status + tiles));
  return (int)cudaGetLastError();
}
