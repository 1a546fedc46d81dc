// K4: dense-stream decode for Hopper (sm_90a).
//
// Replaces huffman_tpu/ops/pallas/dense_decode.py decode_dense_pallas and its
// kernel _decode_dense_kernel.  That kernel stages every block into its own
// row (inverse-pack staging) and refreshes per-lane word banks with an
// MXU-transposed gather, because a TPU lane cannot read from its own depth
// of memory; it then writes round-major output for an XLA transpose.  On
// Hopper a thread can, so one thread decodes one block from its
// (word_base, bit_shift) cursor with a 64-bit bit buffer.  The single-level
// lookup table, 2**table_bits entries of (symbol << 8) | length, sits in
// shared memory when it fits (table_bits <= 14, 32 KB) and is read from
// device memory otherwise, so every codebook the encoder can produce (codes
// up to 24 bits) decodes here.
//
// What bounds it, and what the design does about it.  The first design
// stored each thread's decoded word straight to its own block row, 4 bytes
// at a 1 KiB stride: 32 partial sectors per warp store.  Folding those
// stores into one word per thread cut its 1 GiB time from 13.2 to 1.7 ms,
// and reading the stream from an L1-resident window as well to 1.6 ms
// (scripts/ablate_decoders.py on an H100): the stores held it back.  So:
//  - output: a thread writes each 32 decoded bytes into a slice of shared
//    memory, and its warp then stores those slices as whole 32-byte
//    sectors, eight neighbouring lanes on one block's eight words;
//  - stream: every thread keeps a ring of three quarters of QW words of its
//    block's stream in shared memory, filled by cp.async.  A stage of 2 QW
//    symbols (QW for codes longer than 14 bits) reads at most QW + 1 words,
//    so it stays within the two quarters that have arrived while the
//    quarter after them loads behind the decode; at the next stage
//    boundary the thread waits for it and, once its cursor has left the
//    oldest quarter, recycles that one for the next QW words;
//  - the lookup chain: a chunk whose 32 bytes are all valid decodes
//    without per-symbol bounds tests, and with codes of at most 14 bits one
//    refill test covers two symbols; shifts are funnel shifts.
// What is left is each thread's chain of dependent table lookups and
// shifts, one per output byte, with the lookups' shared-memory bank
// conflicts: with the staged stores folded away the kernel runs within
// ~10% of its full time.

#include "common.cuh"

namespace {

constexpr int WARPS = 4;                 // warps per CTA
constexpr int THREADS = 32 * WARPS;      // one data block per thread
constexpr int QW = 16;                   // stream words per ring quarter
constexpr int RING = 3 * QW;             // stream words a thread keeps
constexpr int CHUNK = 32;                // output bytes a thread stages
constexpr int CHUNK_WORDS = CHUNK / 4;
constexpr int PITCH = CHUNK_WORDS + 1;   // staged words per lane (+1: banks)
constexpr int SMEM_TABLE_MAX_BITS = 14;

// One thread's block stream: words [base, base + RING) of the stream in a
// ring of three quarters; `rel` is the next word to read, relative to
// base, and quarter `head` of the ring holds words base .. base + QW - 1.
struct StreamRing {
  uint32_t* ring;
  long long next;          // first stream word not yet requested
  int rel, head;

  __device__ void start(const uint32_t* stream, long long n_words,
                        long long wp) {
    const long long base = wp & ~(long long)(QW - 1);
    for (int p = 0; p < RING; p += 4)
      cp_async_words4(ring + p, stream, n_words, base + p);
    cp_async_commit();
    next = base + RING;
    rel = (int)(wp - base);
    head = 0;
  }

  // A stage boundary: wait for every quarter requested so far, then
  // recycle the oldest quarter once the cursor has left it.
  __device__ void stage(const uint32_t* stream, long long n_words) {
    cp_async_wait<0>();
    if (rel >= QW) {
      uint32_t* q = ring + head * QW;
      for (int p = 0; p < QW; p += 4)
        cp_async_words4(q + p, stream, n_words, next + p);
      next += QW;
      head = head == 2 ? 0 : head + 1;
      rel -= QW;
    }
    cp_async_commit();
  }

  __device__ uint32_t read() {
    int q = head + rel / QW;
    q -= q >= 3 ? 3 : 0;
    const uint32_t w = ring[q * QW + (rel & (QW - 1))];
    ++rel;
    return w;
  }
};

// Decode the next four symbols of a thread's block into one word (byte k =
// symbol k).  buf holds `avail` unread stream bits, left-aligned at bit 63.
// With CHECK, only symbols i + k < nvalid are decoded (the others give 0
// and consume nothing), and the buffer is refilled before every symbol
// that could need it; without, all four are decoded, and with PAIR (codes
// of at most 14 bits) one refill test covers two symbols: avail < 2 * tb
// <= 28 leaves room for the 32 new bits.
template <bool CHECK, bool PAIR>
__device__ __forceinline__ uint32_t decode4(StreamRing& sr, uint64_t& buf,
                                            int& avail,
                                            const uint16_t* tab, int tb,
                                            int i, int nvalid) {
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (CHECK || !PAIR || k % 2 == 0) {
      if (avail < (PAIR && !CHECK ? 2 * tb : tb)) {
        buf |= (uint64_t)sr.read() << (32 - avail);
        avail += 32;
      }
    }
    const uint32_t e = tab[buf >> (64 - tb)];
    if (!CHECK || i + k < nvalid) {
      const int len = e & 0xFF;
      word |= (e >> 8) << (8 * k);
      buf = shl64(buf, len);
      avail -= len;
    }
  }
  return word;
}

template <bool SMEM_TABLE>
__global__ void __launch_bounds__(THREADS)
decode_blocks_kernel(const uint32_t* __restrict__ stream, long long n_words,
                     const int64_t* __restrict__ word_base,
                     const int32_t* __restrict__ bit_shift,
                     const int32_t* __restrict__ valid,
                     const uint16_t* __restrict__ table, int table_bits,
                     uint8_t* __restrict__ out, long long nb,
                     int block_bytes) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* rings = smem;                                  // THREADS * RING
  uint32_t* stage_out = smem + THREADS * RING + warp * 32 * PITCH;
  const uint16_t* tab = table;
  if (SMEM_TABLE) {
    uint16_t* s_table = reinterpret_cast<uint16_t*>(
        smem + THREADS * RING + WARPS * 32 * PITCH);
    for (int i = threadIdx.x; i < (1 << table_bits); i += THREADS)
      s_table[i] = table[i];
    __syncthreads();
    tab = s_table;
  }
  StreamRing sr;
  sr.ring = rings + threadIdx.x * RING;
  // output words (of four symbols) per stage: at most QW + 1 stream words
  // each, 2 * QW symbols of up to 14 bits or QW of up to 24 (see the header)
  const int stage_words = (table_bits <= SMEM_TABLE_MAX_BITS ? 2 : 1) * QW / 4;
  uint32_t* out32 = reinterpret_cast<uint32_t*>(out);
  const long long groups = (nb + THREADS - 1) / THREADS;

  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long first = g * THREADS + warp * 32;   // the warp's block 0
    const long long b = first + lane;
    const bool live = b < nb;
    const int nvalid = live ? valid[b] : 0;
    // buf holds `avail` unread stream bits, left-aligned at bit 63
    uint64_t buf = 0;
    int avail = 64;                     // a lane past nb never refills
    if (live) {
      const int sh = bit_shift[b];
      sr.start(stream, n_words, word_base[b]);
      cp_async_wait<0>();
      buf = (uint64_t)sr.read() << (32 + sh);
      avail = 32 - sh;
    }
    for (int c = 0; c < block_bytes; c += CHUNK) {
      // every byte of the chunk is valid: all but a partial last block
      const bool full = c + CHUNK <= nvalid;
#pragma unroll
      for (int wi = 0; wi < CHUNK_WORDS; ++wi) {
        if (wi % stage_words == 0 && live) sr.stage(stream, n_words);
        const int i = c + 4 * wi;
        stage_out[lane * PITCH + wi] =
            full ? decode4<false, SMEM_TABLE>(sr, buf, avail, tab,
                                              table_bits, i, nvalid)
                 : decode4<true, SMEM_TABLE>(sr, buf, avail, tab,
                                             table_bits, i, nvalid);
      }
      __syncwarp();
      // the warp stores its 32 blocks' chunks: eight lanes per block, one
      // word each, so each store instruction writes four whole sectors
      const int w = lane & 7;
#pragma unroll
      for (int r = 0; r < 32; r += 4) {
        const int src = r + (lane >> 3);
        const long long bb = first + src;
        if (bb < nb && c + 4 * w < block_bytes)
          out32[(bb * block_bytes + c) / 4 + w] = stage_out[src * PITCH + w];
      }
      __syncwarp();
    }
  }
}

template <bool SMEM_TABLE>
int launch(const void* stream, long long n_words, const void* word_base,
           const void* bit_shift, const void* valid, const void* table,
           int table_bits, void* out, long long nb, int block_bytes,
           cudaStream_t s) {
  auto kernel = decode_blocks_kernel<SMEM_TABLE>;
  size_t smem = (size_t)(THREADS * RING + WARPS * 32 * PITCH) * 4;
  if (SMEM_TABLE) smem += ((size_t)1 << table_bits) * sizeof(uint16_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = resident_grid(kernel, THREADS, smem,
                                 (nb + THREADS - 1) / THREADS);
  kernel<<<grid, THREADS, smem, s>>>(
      (const uint32_t*)stream, n_words, (const int64_t*)word_base,
      (const int32_t*)bit_shift, (const int32_t*)valid,
      (const uint16_t*)table, table_bits, (uint8_t*)out, nb, block_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// `stream` must be 16-byte aligned (cp.async); block_bytes a multiple of 4.
HUFF_API int huff_decode_blocks(const void* stream, long long n_words,
                                const void* word_base, const void* bit_shift,
                                const void* valid, const void* table,
                                int table_bits, void* out, long long nb,
                                int block_bytes, void* cuda_stream) {
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  if (table_bits <= SMEM_TABLE_MAX_BITS)
    return launch<true>(stream, n_words, word_base, bit_shift, valid, table,
                        table_bits, out, nb, block_bytes, s);
  return launch<false>(stream, n_words, word_base, bit_shift, valid, table,
                       table_bits, out, nb, block_bytes, s);
}
