// K7 emit, with K6 relayout and the pull schedule, for Hopper (sm_90a).
//
// Replaces huffman_tpu/ops/pallas/wide.py emit_planes_pallas (kernel
// _emit_kernel), relayout_pallas (K6, _relayout_kernel) and the XLA scan
// huffman_tpu/wide.py _schedule_counts over _l2p_device and _nk_device.  On
// the TPU, K6 transposes K5's streams into word rows, because a lane cannot
// gather from another lane's memory; the schedule is a 64-step XLA scan; and
// K7 routes each pulling lane's word pair with a lane-gather tournament, MXU
// ranks and SMEM base windows into (NT, 384, 128) scratch planes, which the
// host then compacts tile by tile.  Here one CTA of 1024 threads takes a
// tile, thread k substream k, in two kernels:
//   (a) wide_schedule_kernel: each substream's 64-bit pull mask, the
//       per-round bases and the tile's plane length.  An int64
//       torch.cumsum of 2 * tile_words then gives each tile's payload
//       offset.
//   (b) wide_emit_kernel: from the masks, every pulled word pair straight
//       into the container payload, P0 at offset + base + rank and P1
//       tile_words later.  K5's streams are read in place, so K6 has no
//       kernel, and the host assembles nothing.
//
// What bounds it.  A substream's pulls depend on nothing but its own l2
// bytes and length; only its rank within a round depends on the others.
// The first design ran the spec's 64 rounds in lock step in both kernels,
// a CTA-wide count per round (128 barriers a tile in K7, 64 in the
// schedule) for about one pull in six threads: 10.7% of its bytes bound
// at 64 MiB.  Its ablations (scripts/ablate_emit.py on an H100) put 37% of
// its time in the word loads, each lane reading its own row 392 bytes from
// the next, and next to nothing in the barriers.  So:
//   1. the schedule works out each thread's pull mask first, from four
//      16-byte l2 loads and with no barrier (pull_mask), and stores it, so
//      that K7 reads 8 bytes a substream in place of l2 and the chain;
//   2. a 32 x 32 bit transpose of the masks (warp_transpose) gives each
//      warp's ballot of every round, and the counts are scanned across
//      warps round by round: two barriers a tile (scan_rounds);
//   3. K7's warps copy the word pairs their substreams will pull, up to
//      ROW_PAIRS each, into shared memory by coalesced 8-byte cp.async
//      behind the scan (stage_rows), then place the pulls round by round,
//      so that a warp's stores of one round land on consecutive payload
//      words (place_pulls).
// What is left is instructions and latency more than bytes (30% of the
// bytes bound at 64 MiB, 41% at 1 GiB): placing the pulls, each warp's walk
// over the rounds with its reads and stores, is 44-47% of the pair's time,
// the word copies 32-41% (ablations).

#include "common.cuh"

namespace {

constexpr int WIDE_WARPS = WIDE_N_SUB / 32;
constexpr int ROUND_PITCH = WIDE_ROUNDS + 1;   // +1: columns on all banks
constexpr int ROW_PAIRS = 10;        // word pairs of each substream K7 stages
constexpr int ROW_PITCH = 2 * ROW_PAIRS + 2;   // an odd count of pairs: banks
constexpr int ROWS_A_COPY = 32 / ROW_PAIRS;    // rows a warp copies at once

// Every warp's ballot of every round, and the column scan of their counts:
// round[w][j] holds warp w's pull lanes of round j (x) and the pulls of
// round j before warp w (y).
struct RoundScan {
  uint2 round[WIDE_WARPS][ROUND_PITCH];
  int32_t tot[WIDE_ROUNDS];                    // round j's pulls in the tile
};

// Bit j of the result is set iff a substream of n_k bytes whose 64 l2
// bytes are `items` pulls in round j.  They are read as four 16-byte
// loads, all at once.
__device__ __forceinline__ uint64_t pull_mask(const uint4* items, int n_k,
                                              int mcl) {
  uint64_t m = 0;
  int avail = 0;
#pragma unroll
  for (int q = 0; q < WIDE_ITEMS / 16; ++q) {
    const uint4 v = items[q];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = 16 * q + i;
      const bool pull = wide_pulls(avail, n_k, j, mcl);
      m |= (uint64_t)pull << j;
      avail += (pull ? 64 : 0) - (int)((w[i >> 2] >> (8 * (i & 3))) & 255u);
    }
  }
  return m;
}

// Lane l's result holds bit l of every lane's x: bit i of it is bit l of
// lane i's x (the ballot of bit l), a 32 x 32 bit transpose in five
// butterfly exchanges.
__device__ __forceinline__ uint32_t warp_transpose(uint32_t x) {
  const int lane = threadIdx.x & 31;
  uint32_t mask = 0x0000ffffu;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1, mask ^= mask << d) {
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, d);
    x = lane & d ? (x & ~mask) | ((y >> d) & mask)
                 : (x & mask) | ((y & mask) << d);
  }
  return x;
}

// Every thread of the CTA passes its pull mask.  Afterwards s.round[w][j]
// holds warp w's ballot of round j and the pulls of round j in warps before
// w plus base[j] (0 without base), and s.tot[j] round j's pulls.  Two
// barriers.
__device__ __forceinline__ void scan_rounds(uint64_t m, RoundScan& s,
                                            const int32_t* base) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the ballots of rounds lane and lane + 32
  const uint32_t lo = warp_transpose((uint32_t)m);
  const uint32_t hi = warp_transpose((uint32_t)(m >> 32));
  s.round[warp][lane] = make_uint2(lo, __popc(lo));
  s.round[warp][lane + 32] = make_uint2(hi, __popc(hi));
  __syncthreads();
  // warp w scans rounds 2w and 2w + 1 across the warps, lane l for warp l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = 2 * warp + r;
    const uint32_t c = s.round[lane][j].y;
    const uint32_t incl = warp_inclusive_scan(c);
    s.round[lane][j].y = incl - c + (base ? base[j] : 0);
    if (lane == 31) s.tot[j] = (int32_t)incl;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(WIDE_N_SUB, 2)
wide_schedule_kernel(const uint8_t* __restrict__ l2,
                     const int32_t* __restrict__ tile_bytes,
                     int32_t* __restrict__ bases,
                     int32_t* __restrict__ tile_words,
                     uint64_t* __restrict__ masks, int mcl) {
  __shared__ RoundScan s;
  const int t = blockIdx.x, k = threadIdx.x;
  const long long row = (long long)t * WIDE_N_SUB + k;
  const uint64_t m = pull_mask(
      reinterpret_cast<const uint4*>(l2 + row * WIDE_ITEMS),
      wide_substream_valid(tile_bytes[t], k), mcl);
  scan_rounds(m, s, nullptr);
  masks[row] = m;
  if (k < 32) {                            // warp 0: bases = scan of s.tot
    const uint32_t a = s.tot[k], b = s.tot[k + 32];
    const uint32_t ia = warp_inclusive_scan(a);
    const uint32_t ib = warp_inclusive_scan(b) + __shfl_sync(0xffffffffu,
                                                             ia, 31);
    bases[t * WIDE_ROUNDS + k] = (int32_t)(ia - a);
    bases[t * WIDE_ROUNDS + k + 32] = (int32_t)(ib - b);
    if (k == 31) tile_words[t] = (int32_t)ib;
  }
}

// Word pair i (words 2i, 2i + 1) of a substream's stream of `slot` words,
// zero past it; one 8-byte load where slot is even (rows 8-byte aligned).
__device__ __forceinline__ uint2 word_pair(const uint32_t* src, int slot,
                                           int i) {
  const int w = 2 * i;
  if (!(slot & 1))
    return w < slot ? *reinterpret_cast<const uint2*>(src + w)
                    : make_uint2(0u, 0u);
  return make_uint2(w < slot ? src[w] : 0u, w + 1 < slot ? src[w + 1] : 0u);
}

// Word pairs of a substream that K7 stages: none where slot is odd (rows
// not 8-byte aligned).
__device__ __forceinline__ int staged_pairs(int slot) {
  return slot & 1 ? 0 : min(ROW_PAIRS, slot / 2);
}

// Each warp copies the word pairs its 32 substreams will pull (at most
// ROW_PAIRS of each) into their staged rows in shared memory, ROWS_A_COPY
// rows at a time, a lane a pair, by 8-byte cp.async: one coalesced read of
// the words each row needs.
__device__ __forceinline__ void stage_rows(uint64_t m, const uint32_t* rows,
                                           int slot, uint32_t* staged) {
  const int lane = threadIdx.x & 31;
  const int pairs = min(__popcll(m), staged_pairs(slot));
  const int rr = lane / ROW_PAIRS, pp = lane % ROW_PAIRS;
#pragma unroll 1
  for (int r0 = 0; r0 < 32; r0 += ROWS_A_COPY) {
    const int r = r0 + rr;
    const int n = __shfl_sync(0xffffffffu, pairs, r & 31);
    if (rr < ROWS_A_COPY && r < 32 && pp < n) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(
          staged + r * ROW_PITCH + 2 * pp);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                   "l"(rows + (long long)r * slot + 2 * pp)
                   : "memory");
    }
  }
  cp_async_commit();
}

// Round by round, each pulling lane of a warp stores its next word pair at
// its place: the lanes of one round take consecutive payload words.  The
// pair comes from the lane's staged row, or from device memory past it.
__device__ __forceinline__ void place_pulls(uint64_t m, const RoundScan& s,
                                            const uint32_t* staged,
                                            const uint32_t* src, int slot,
                                            uint32_t* p0, uint32_t* p1,
                                            int tw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t below = (1u << lane) - 1u;
  const int in_stage = staged_pairs(slot);
  // the rounds up to the warp's last pull
  const uint32_t any_lo = __reduce_or_sync(0xffffffffu, (uint32_t)m);
  const uint32_t any_hi = __reduce_or_sync(0xffffffffu, (uint32_t)(m >> 32));
  const int end = any_hi ? 64 - __clz(any_hi) : 32 - __clz(any_lo);
  int i = 0;                               // pulls so far
#pragma unroll 4
  for (int j = 0; j < end; ++j) {
    const uint2 r = s.round[warp][j];
    if (!((r.x >> lane) & 1u)) continue;
    const int pos = (int)(r.y + __popc(r.x & below));
    if (pos < tw) {
      const uint2 v = i < in_stage
                          ? *reinterpret_cast<const uint2*>(staged + 2 * i)
                          : word_pair(src, slot, i);
      p0[pos] = v.x;
      p1[pos] = v.y;
    }
    ++i;
  }
}

__global__ void __launch_bounds__(WIDE_N_SUB, 2)
wide_emit_kernel(const uint32_t* __restrict__ streams, int slot,
                 const uint64_t* __restrict__ masks,
                 const int32_t* __restrict__ bases,
                 const int32_t* __restrict__ tile_words,
                 const int64_t* __restrict__ offsets,
                 uint32_t* __restrict__ payload) {
  extern __shared__ __align__(16) uint32_t staged[];  // WIDE_N_SUB rows
  __shared__ RoundScan s;
  const int t = blockIdx.x, k = threadIdx.x;
  const long long row = (long long)t * WIDE_N_SUB + k;
  const uint64_t m = masks[row];
  stage_rows(m, streams + (row - (k & 31)) * slot, slot,
             staged + (k & ~31) * ROW_PITCH);
  scan_rounds(m, s, bases + t * WIDE_ROUNDS);
  cp_async_wait<0>();
  __syncwarp();                            // the warp's rows have arrived
  const int tw = tile_words[t];
  uint32_t* p0 = payload + offsets[t];
  place_pulls(m, s, staged + k * ROW_PITCH, streams + row * slot, slot, p0,
              p0 + tw, tw);
}

}  // namespace

// l2 is (nt * WIDE_N_SUB, WIDE_ITEMS) bytes at a 16-byte aligned address;
// masks gets one 64-bit pull mask a substream.
HUFF_API int huff_wide_schedule(const void* l2, const void* tile_bytes,
                                void* bases, void* tile_words, void* masks,
                                int nt, int mcl, void* stream) {
  wide_schedule_kernel<<<nt, WIDE_N_SUB, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)l2, (const int32_t*)tile_bytes, (int32_t*)bases,
      (int32_t*)tile_words, (uint64_t*)masks, mcl);
  return (int)cudaGetLastError();
}

// streams is (nt * WIDE_N_SUB, slot) words at an 8-byte aligned address;
// masks, bases and tile_words come from huff_wide_schedule.
HUFF_API int huff_wide_emit(const void* streams, int slot, const void* masks,
                            const void* bases, const void* tile_words,
                            const void* offsets, int nt, void* payload,
                            void* stream) {
  const int smem = WIDE_N_SUB * ROW_PITCH * sizeof(uint32_t);
  const cudaError_t e = cudaFuncSetAttribute(
      wide_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  wide_emit_kernel<<<nt, WIDE_N_SUB, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)streams, slot, (const uint64_t*)masks,
      (const int32_t*)bases, (const int32_t*)tile_words,
      (const int64_t*)offsets, (uint32_t*)payload);
  return (int)cudaGetLastError();
}
