// K4: dense-stream decode for Hopper (sm_90a).
//
// Replaces huffman_tpu/ops/pallas/dense_decode.py decode_dense_pallas and its
// kernel _decode_dense_kernel.  That kernel stages every block into its own
// row (inverse-pack staging) and refreshes per-lane word banks with an
// MXU-transposed gather, because a TPU lane cannot read from its own depth
// of memory; it then writes round-major output for an XLA transpose.  On
// Hopper a thread can, so one thread decodes one block straight from its
// (word_base, bit_shift) cursor with a 64-bit bit buffer and writes its
// bytes block-major.  The single-level lookup table, 2**table_bits entries
// of (symbol << 8) | length, sits in shared memory when it fits (table_bits
// <= 14, 32 KB) and is read from device memory otherwise, so every codebook
// the encoder can produce (codes up to 24 bits) decodes here.
//
// What bounds it on the card: each thread's chain of dependent table
// lookups and shifts, one per output byte; device memory moves the stream
// once and the output once (1 byte per byte decoded), with uncoalesced
// per-thread stores.

#include "common.cuh"

namespace {

template <bool SMEM_TABLE>
__global__ void decode_blocks_kernel(const uint32_t* __restrict__ stream,
                                     long long n_words,
                                     const int64_t* __restrict__ word_base,
                                     const int32_t* __restrict__ bit_shift,
                                     const int32_t* __restrict__ valid,
                                     const uint16_t* __restrict__ table,
                                     int table_bits, uint8_t* __restrict__ out,
                                     long long nb, int block_bytes) {
  extern __shared__ uint16_t s_table[];
  const uint16_t* tab = table;
  if (SMEM_TABLE) {
    for (int i = threadIdx.x; i < (1 << table_bits); i += blockDim.x)
      s_table[i] = table[i];
    __syncthreads();
    tab = s_table;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x; b < nb;
       b += stride) {
    long long wp = word_base[b];
    const int sh = bit_shift[b];
    const int nvalid = valid[b];
    // buf holds `avail` unread stream bits, left-aligned at bit 63
    uint64_t buf = (uint64_t)(wp < n_words ? stream[wp] : 0u) << (32 + sh);
    int avail = 32 - sh;
    ++wp;
    uint32_t* dst = (uint32_t*)(out + b * block_bytes);
    for (int i = 0; i < block_bytes; i += 4) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (avail < table_bits) {        // then avail + 32 <= 55 bits fit
          buf |= (uint64_t)(wp < n_words ? stream[wp] : 0u) << (32 - avail);
          avail += 32;
          ++wp;
        }
        const uint32_t e = tab[buf >> (64 - table_bits)];
        if (i + k < nvalid) {
          const int len = e & 0xFF;
          word |= (e >> 8) << (8 * k);
          buf <<= len;
          avail -= len;
        }
      }
      dst[i >> 2] = word;
    }
  }
}

}  // namespace

HUFF_API int huff_decode_blocks(const void* stream, long long n_words,
                                const void* word_base, const void* bit_shift,
                                const void* valid, const void* table,
                                int table_bits, void* out, long long nb,
                                int block_bytes, int smem_table, int grid,
                                int threads, void* cuda_stream) {
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  if (smem_table) {
    const size_t smem = ((size_t)1 << table_bits) * sizeof(uint16_t);
    decode_blocks_kernel<true><<<grid, threads, smem, s>>>(
        (const uint32_t*)stream, n_words, (const int64_t*)word_base,
        (const int32_t*)bit_shift, (const int32_t*)valid,
        (const uint16_t*)table, table_bits, (uint8_t*)out, nb, block_bytes);
  } else {
    decode_blocks_kernel<false><<<grid, threads, 0, s>>>(
        (const uint32_t*)stream, n_words, (const int64_t*)word_base,
        (const int32_t*)bit_shift, (const int32_t*)valid,
        (const uint16_t*)table, table_bits, (uint8_t*)out, nb, block_bytes);
  }
  return (int)cudaGetLastError();
}
