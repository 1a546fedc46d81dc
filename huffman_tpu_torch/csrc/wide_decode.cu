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
// exclusive count of the pull flags as the rank, the word pair read
// straight from the payload at offset + bases[t, j] + rank (P0) and
// tile_words later (P1), inserted into a 128-bit buffer (two uint64) at bit
// `avail` <= 47, and four symbols out by a 2^mcl-entry (symbol, length)
// table in shared memory, as K4 does.  Substream k's bytes 4j .. 4j + 3
// leave as one 4-byte store per round at t * TILE_BYTES + 256k + 4j, so
// the output is plain tile-major bytes.
//
// What bounds it on the card: each thread's chain of dependent table
// lookups and shifts (256 per substream) and the two CTA barriers of each
// round's rank; the stores are 4 bytes at a 256-byte stride.

#include "common.cuh"

namespace {

constexpr int MAX_TABLE_BITS = 12;

__global__ void __launch_bounds__(WIDE_N_SUB)
wide_decode_kernel(const uint32_t* __restrict__ payload, long long n_words,
                   const int64_t* __restrict__ offsets,
                   const int32_t* __restrict__ tile_words,
                   const int32_t* __restrict__ bases,
                   const int32_t* __restrict__ tile_bytes,
                   const uint16_t* __restrict__ table, int mcl,
                   uint8_t* __restrict__ out) {
  __shared__ uint16_t s_tab[1 << MAX_TABLE_BITS];
  __shared__ uint32_t s_scan[33];
  __shared__ int32_t s_base[WIDE_ROUNDS];
  const int t = blockIdx.x, k = threadIdx.x;
  for (int i = k; i < (1 << mcl); i += blockDim.x) s_tab[i] = table[i];
  if (k < WIDE_ROUNDS) s_base[k] = bases[t * WIDE_ROUNDS + k];
  __syncthreads();
  const int n_k = wide_substream_valid(tile_bytes[t], k);
  const long long p0 = offsets[t];
  const long long p1 = p0 + tile_words[t];
  uint32_t* dst = reinterpret_cast<uint32_t*>(
      out + t * WIDE_TILE_BYTES + (long long)WIDE_SUB_BYTES * k);
  // hi: the next 64 unread bits, MSB first; lo: the 64 after them
  uint64_t hi = 0, lo = 0;
  int avail = 0;
  for (int j = 0; j < WIDE_ROUNDS; ++j) {
    const bool pull = wide_pulls(avail, n_k, j, mcl);
    uint32_t total;
    const uint32_t rank = cta_exclusive_count(pull, s_scan, &total);
    if (pull) {
      const long long pos = s_base[j] + (long long)rank;
      const uint64_t w0 = p0 + pos < n_words ? payload[p0 + pos] : 0u;
      const uint64_t w1 = p1 + pos < n_words ? payload[p1 + pos] : 0u;
      const uint64_t w = (w0 << 32) | w1;
      // insert at bit avail (0 <= avail <= 47); a shift by 64 is undefined
      hi |= w >> avail;
      lo |= avail ? w << (64 - avail) : 0ull;
      avail += 64;
    }
    uint32_t word = 0;
#pragma unroll
    for (int u = 0; u < WIDE_SPR; ++u) {
      if (WIDE_SPR * j + u < n_k) {
        const uint32_t e = s_tab[hi >> (64 - mcl)];
        const int len = e & 0xFF;
        word |= (e >> 8) << (8 * u);
        if (len) {
          hi = (hi << len) | (lo >> (64 - len));
          lo <<= len;
        }
        avail -= len;
      }
    }
    dst[j] = word;
  }
}

}  // namespace

HUFF_API int huff_wide_decode(const void* payload, long long n_words,
                              const void* offsets, const void* tile_words,
                              const void* bases, const void* tile_bytes,
                              const void* table, int mcl, void* out, int nt,
                              void* stream) {
  if (mcl < 1 || mcl > MAX_TABLE_BITS) return (int)cudaErrorInvalidValue;
  wide_decode_kernel<<<nt, WIDE_N_SUB, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)payload, n_words, (const int64_t*)offsets,
      (const int32_t*)tile_words, (const int32_t*)bases,
      (const int32_t*)tile_bytes, (const uint16_t*)table, mcl,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}
