// K7 emit, with K6 relayout and the pull schedule, for Hopper (sm_90a).
//
// Replaces huffman_tpu/ops/pallas/wide.py emit_planes_pallas (kernel
// _emit_kernel), relayout_pallas (K6, _relayout_kernel) and the XLA scan
// huffman_tpu/wide.py _schedule_counts over _l2p_device and _nk_device.  On
// the TPU, K6 transposes K5's streams into word rows, because a lane cannot
// gather from another lane's memory; the schedule is a 64-step XLA scan; and
// K7 routes each pulling lane's word pair with a lane-gather tournament, MXU
// ranks and SMEM base windows into (NT, 384, 128) scratch planes, which the
// host then compacts tile by tile.  Hopper gathers freely and has a
// CTA-wide ballot scan, so here two passes of one CTA of 1024 threads per
// tile, thread k for substream k, run the spec's 64 rounds:
//   (a) wide_schedule_kernel: the pull mask of each round and its CTA-wide
//       count (__syncthreads_count) give the per-round bases and the tile's
//       plane length.  An int64 torch.cumsum of 2 * tile_words then gives
//       each tile's payload offset.
//   (b) wide_emit_kernel: the same rounds again; a pulling thread's rank is
//       the CTA-wide exclusive count of the pull flags (warp ballot +
//       popc), and it writes its substream's next two words straight into
//       the container payload: P0 at offset + base + rank, P1 tile_words
//       later.  K5's streams are read in place, so K6 has no kernel.
// Nothing goes through scratch planes, and the host assembles nothing.
//
// What bounds it on the card: 64 rounds of two CTA barriers each, with
// uncoalesced 4-byte reads of each substream's words (the rows are
// 8 * mcl + 2 words apart) and of its l2 byte per round.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(WIDE_N_SUB)
wide_schedule_kernel(const uint8_t* __restrict__ l2,
                     const int32_t* __restrict__ tile_bytes,
                     int32_t* __restrict__ bases,
                     int32_t* __restrict__ tile_words, int mcl) {
  const int t = blockIdx.x, k = threadIdx.x;
  const uint8_t* items = l2 + ((long long)t * WIDE_N_SUB + k) * WIDE_ITEMS;
  const int n_k = wide_substream_valid(tile_bytes[t], k);
  int avail = 0, base = 0;
  for (int j = 0; j < WIDE_ROUNDS; ++j) {
    const bool pull = wide_pulls(avail, n_k, j, mcl);
    const int cnt = __syncthreads_count(pull);
    if (k == 0) bases[t * WIDE_ROUNDS + j] = base;
    base += cnt;
    avail += (pull ? 64 : 0) - items[j];
  }
  if (k == 0) tile_words[t] = base;
}

__global__ void __launch_bounds__(WIDE_N_SUB)
wide_emit_kernel(const uint32_t* __restrict__ streams, int slot,
                 const uint8_t* __restrict__ l2,
                 const int32_t* __restrict__ tile_bytes,
                 const int32_t* __restrict__ bases,
                 const int32_t* __restrict__ tile_words,
                 const int64_t* __restrict__ offsets, int mcl,
                 uint32_t* __restrict__ payload) {
  __shared__ uint32_t s_scan[33];
  __shared__ int32_t s_base[WIDE_ROUNDS];
  const int t = blockIdx.x, k = threadIdx.x;
  const long long row = (long long)t * WIDE_N_SUB + k;
  const uint8_t* items = l2 + row * WIDE_ITEMS;
  const uint32_t* src = streams + row * slot;
  if (k < WIDE_ROUNDS) s_base[k] = bases[t * WIDE_ROUNDS + k];
  // (the first scan's barriers publish s_base before it is read)
  const int n_k = wide_substream_valid(tile_bytes[t], k);
  const int tw = tile_words[t];
  uint32_t* p0 = payload + offsets[t];
  uint32_t* p1 = p0 + tw;
  int avail = 0, wcur = 0;
  for (int j = 0; j < WIDE_ROUNDS; ++j) {
    const bool pull = wide_pulls(avail, n_k, j, mcl);
    uint32_t total;
    const uint32_t rank = cta_exclusive_count(pull, s_scan, &total);
    const int pos = s_base[j] + (int)rank;
    if (pull && pos < tw) {
      p0[pos] = wcur < slot ? src[wcur] : 0u;
      p1[pos] = wcur + 1 < slot ? src[wcur + 1] : 0u;
    }
    wcur += pull ? 2 : 0;
    avail += (pull ? 64 : 0) - items[j];
  }
}

}  // namespace

HUFF_API int huff_wide_schedule(const void* l2, const void* tile_bytes,
                                void* bases, void* tile_words, int nt,
                                int mcl, void* stream) {
  wide_schedule_kernel<<<nt, WIDE_N_SUB, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)l2, (const int32_t*)tile_bytes, (int32_t*)bases,
      (int32_t*)tile_words, mcl);
  return (int)cudaGetLastError();
}

HUFF_API int huff_wide_emit(const void* streams, int slot, const void* l2,
                            const void* tile_bytes, const void* bases,
                            const void* tile_words, const void* offsets,
                            int nt, int mcl, void* payload, void* stream) {
  wide_emit_kernel<<<nt, WIDE_N_SUB, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)streams, slot, (const uint8_t*)l2,
      (const int32_t*)tile_bytes, (const int32_t*)bases,
      (const int32_t*)tile_words, (const int64_t*)offsets, mcl,
      (uint32_t*)payload);
  return (int)cudaGetLastError();
}
