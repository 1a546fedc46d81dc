// K8: wide-format decode for Hopper (sm_90a).
//
// Replaces huffman_tpu/ops/pallas/wide.py decode_wide_pallas and its
// kernel _decode_wide_kernel.  The TPU reader ranks pulls with an MXU
// matmul, fetches each pulling lane's words with a two-row staircase of
// sublane and lane gathers out of DMA'd payload windows, decodes by
// table-free canonical compares (no per-lane table lookup), batches
// td tiles per grid step to hide its latency chain, and writes round-major
// words that an XLA transpose turns back into bytes.  Here one CTA of 1024
// threads decodes one tile, thread k for substream k, through the spec's 64
// rounds (golden/wide_codec.py decode_tile): the pull rule, the CTA-wide
// exclusive count of the pull flags as the rank, the word pair at plane
// position bases[t, j] + rank of P0 and P1, inserted into a 128-bit buffer
// (two uint64) at bit `avail` <= 47, and four symbols out by a
// 2^mcl-entry (symbol, length) table in shared memory, as K4 does.
//
// What bounds it, and what the design does about it.  The first design
// stored each round's word straight to the output, 4 bytes at a 256-byte
// stride; folding those stores into one word per thread cut its 1 GiB time
// from 9.3 to 2.3 ms, while reading the payload from L1 instead of device
// memory saved 0.3 ms and a rank without barriers nothing
// (scripts/ablate_decoders.py on an H100).  So:
//  - output: each warp keeps OUT_ROUNDS rounds of its 32 substreams' words
//    in shared memory and then stores them as runs of 4 * OUT_ROUNDS
//    bytes, OUT_ROUNDS neighbouring lanes on one substream's run (a whole
//    32-byte sector);
//  - payload: rounds 4w .. 4w + 3 read exactly plane positions
//    [bases[t, 4w], bases[t, 4w + 4]) (the last window ends at
//    tile_words[t]), so that window of P0 and of P1 is copied into shared
//    memory with cp.async by the whole CTA, one window ahead of the rounds
//    that read it (double-buffered).  A pull then reads shared memory;
//    a position outside the window (only a corrupt container has one)
//    reads device memory, so every input decodes as before;
//  - one CTA barrier a round: the per-warp pull counts alternate between
//    two buffers, the barrier that publishes a round's counts also
//    publishes the payload window that round starts, and each warp sums
//    the counts before it with one warp reduction;
//  - occupancy: registers are capped at 32 (a few bytes spill) so that two
//    CTAs of 1024 threads share an SM and one runs while the other waits
//    at its barrier; with one CTA per SM (56 registers, 16 staged rounds)
//    it ran 10% slower.
// What is left is each thread's chain of dependent table lookups and
// 128-bit shifts (256 per substream) and the barrier of each round: with
// the staged stores folded away it runs within ~7% of its full time.

#include "common.cuh"

namespace {

constexpr int MAX_TABLE_BITS = 12;
constexpr int WARPS = WIDE_N_SUB / 32;
constexpr int WIN_ROUNDS = 4;                      // rounds per window
constexpr int WINDOWS = WIDE_ROUNDS / WIN_ROUNDS;
// a window of one plane: at most one pull per substream and round, and up
// to 3 words before it from aligning its start to 16 bytes
constexpr int WIN_WORDS = WIN_ROUNDS * WIDE_N_SUB + 4;
constexpr int OUT_ROUNDS = 8;                      // rounds staged per store
constexpr int PITCH = OUT_ROUNDS + 1;              // +1: no bank conflicts
constexpr int CTAS_PER_SM = 2;                     // the register budget
constexpr size_t SMEM_BYTES =
    (size_t)(4 * WIN_WORDS + WARPS * 32 * PITCH) * sizeof(uint32_t);

// The window of one plane that starts at payload word p, for plane
// positions [lo, hi): its first word p + ofs, 16-byte aligned, and the
// number of words copied.
struct Window {
  int ofs, len;
  __device__ Window(long long p, int lo, int hi) {
    ofs = lo - (int)((p + lo) & 3);
    const int n = hi - ofs;
    len = n < 0 ? 0 : n > WIN_WORDS ? WIN_WORDS : (n + 3) & ~3;
  }
};

// Plane word `pos` of the plane that starts at payload word p: from the
// shared-memory window when it holds it, else from device memory (zero
// past the payload).
__device__ __forceinline__ uint32_t plane_word(const uint32_t* win,
                                               const Window& w,
                                               const uint32_t* payload,
                                               long long n_words, long long p,
                                               int pos) {
  const unsigned r = (unsigned)(pos - w.ofs);
  if (r < (unsigned)w.len) return win[r];
  return p + pos < n_words ? payload[p + pos] : 0u;
}

// (hi:lo) <<= s for 0 <= s <= 31: four funnel shifts of 32-bit quarters.
__device__ __forceinline__ void shl128(uint64_t& hi, uint64_t& lo, int s) {
  const uint32_t a3 = (uint32_t)(hi >> 32), a2 = (uint32_t)hi;
  const uint32_t a1 = (uint32_t)(lo >> 32), a0 = (uint32_t)lo;
  hi = ((uint64_t)__funnelshift_l(a2, a3, s) << 32) | __funnelshift_l(a1, a2, s);
  lo = ((uint64_t)__funnelshift_l(a0, a1, s) << 32) | (a0 << s);
}

// Decode one round's four symbols into one word (byte u = symbol u); with
// CHECK only symbols 4j + u < n_k, the others give 0 and consume nothing.
template <bool CHECK>
__device__ __forceinline__ uint32_t decode4(uint64_t& hi, uint64_t& lo,
                                            int& avail, const uint16_t* tab,
                                            int mcl, int first, int n_k) {
  uint32_t word = 0;
#pragma unroll
  for (int u = 0; u < WIDE_SPR; ++u) {
    if (!CHECK || first + u < n_k) {
      const uint32_t e = tab[hi >> (64 - mcl)];
      const int len = e & 0xFF;
      word |= (e >> 8) << (8 * u);
      shl128(hi, lo, len);
      avail -= len;
    }
  }
  return word;
}

__global__ void __launch_bounds__(WIDE_N_SUB, CTAS_PER_SM)
wide_decode_kernel(const uint32_t* __restrict__ payload, long long n_words,
                   const int64_t* __restrict__ offsets,
                   const int32_t* __restrict__ tile_words,
                   const int32_t* __restrict__ bases,
                   const int32_t* __restrict__ tile_bytes,
                   const uint16_t* __restrict__ table, int mcl,
                   uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint16_t s_tab[1 << MAX_TABLE_BITS];
  __shared__ int32_t s_base[WIDE_ROUNDS + 1];
  __shared__ uint32_t s_cnt[2][WARPS];
  const int t = blockIdx.x, k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  uint32_t* s_win = smem;                       // [buffer][plane][WIN_WORDS]
  uint32_t* s_out = smem + 4 * WIN_WORDS + warp * 32 * PITCH;
  for (int i = k; i < (1 << mcl); i += blockDim.x) s_tab[i] = table[i];
  if (k < WIDE_ROUNDS) s_base[k] = bases[t * WIDE_ROUNDS + k];
  if (k == WIDE_ROUNDS) s_base[k] = tile_words[t];
  __syncthreads();
  const int n_k = wide_substream_valid(tile_bytes[t], k);
  const long long p0 = offsets[t];
  const long long p1 = p0 + s_base[WIDE_ROUNDS];

  // the CTA copies window w of both planes into buffer w & 1
  auto fetch = [&](int w) {
    const int lo = s_base[WIN_ROUNDS * w], hi = s_base[WIN_ROUNDS * (w + 1)];
    for (int plane = 0; plane < 2; ++plane) {
      const long long p = plane ? p1 : p0;
      const Window win(p, lo, hi);
      uint32_t* dst = s_win + ((w & 1) * 2 + plane) * WIN_WORDS;
      for (int i = 4 * k; i < win.len; i += 4 * WIDE_N_SUB)
        cp_async_words4(dst + i, payload, n_words, p + win.ofs + i);
    }
    cp_async_commit();
  };
  fetch(0);

  // hi: the next 64 unread bits, MSB first; lo: the 64 after them
  uint64_t hi = 0, lo = 0;
  int avail = 0;
  Window w0(p0, 0, 0), w1(p1, 0, 0);
  uint32_t* out32 = reinterpret_cast<uint32_t*>(out + t * WIDE_TILE_BYTES);
  for (int j = 0; j < WIDE_ROUNDS; ++j) {
    const bool pull = wide_pulls(avail, n_k, j, mcl);
    const uint32_t ballot = __ballot_sync(0xffffffffu, pull);
    if (lane == 0) s_cnt[j & 1][warp] = __popc(ballot);
    const bool window_start = j % WIN_ROUNDS == 0;
    if (window_start) cp_async_wait<0>();
    __syncthreads();                  // counts and this round's window
    if (window_start) {
      const int w = j / WIN_ROUNDS;
      if (w + 1 < WINDOWS) fetch(w + 1);
      const int lo_ = s_base[j], hi_ = s_base[j + WIN_ROUNDS];
      w0 = Window(p0, lo_, hi_);
      w1 = Window(p1, lo_, hi_);
    }
    // rank: the pulls of the warps before this one, then of the lanes
    // before this one in its warp
    const uint32_t rank =
        __reduce_add_sync(0xffffffffu, lane < warp ? s_cnt[j & 1][lane] : 0u) +
        __popc(ballot & ((1u << lane) - 1u));
    if (pull) {
      const int pos = s_base[j] + (int)rank;
      const uint32_t* win0 = s_win + ((j / WIN_ROUNDS) & 1) * 2 * WIN_WORDS;
      const uint32_t* win1 = win0 + WIN_WORDS;
      const uint64_t v =
          ((uint64_t)plane_word(win0, w0, payload, n_words, p0, pos) << 32) |
          plane_word(win1, w1, payload, n_words, p1, pos);
      // insert at bit avail (0 <= avail <= 47); a shift by 64 is undefined
      hi |= v >> avail;
      lo |= avail ? v << (64 - avail) : 0ull;
      avail += 64;
    }
    const uint32_t word =
        WIDE_SPR * (j + 1) <= n_k
            ? decode4<false>(hi, lo, avail, s_tab, mcl, WIDE_SPR * j, n_k)
            : decode4<true>(hi, lo, avail, s_tab, mcl, WIDE_SPR * j, n_k);
    s_out[lane * PITCH + j % OUT_ROUNDS] = word;
    if (j % OUT_ROUNDS == OUT_ROUNDS - 1) {
      // the warp stores the last OUT_ROUNDS rounds of its 32 substreams:
      // OUT_ROUNDS neighbouring lanes per substream, on its 4 * OUT_ROUNDS
      // contiguous bytes (one whole sector)
      __syncwarp();
      const int c = lane & (OUT_ROUNDS - 1);
#pragma unroll
      for (int r = 0; r < 32; r += 32 / OUT_ROUNDS) {
        const int src = r + lane / OUT_ROUNDS;
        out32[(warp * 32 + src) * (WIDE_SUB_BYTES / 4) + j - (OUT_ROUNDS - 1) +
              c] = s_out[src * PITCH + c];
      }
      __syncwarp();
    }
  }
}

}  // namespace

// `payload` must be 16-byte aligned (cp.async).
HUFF_API int huff_wide_decode(const void* payload, long long n_words,
                              const void* offsets, const void* tile_words,
                              const void* bases, const void* tile_bytes,
                              const void* table, int mcl, void* out, int nt,
                              void* stream) {
  if (mcl < 1 || mcl > MAX_TABLE_BITS) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      wide_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wide_decode_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  wide_decode_kernel<<<nt, WIDE_N_SUB, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const uint32_t*)payload, n_words, (const int64_t*)offsets,
      (const int32_t*)tile_words, (const int32_t*)bases,
      (const int32_t*)tile_bytes, (const uint16_t*)table, mcl,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}
