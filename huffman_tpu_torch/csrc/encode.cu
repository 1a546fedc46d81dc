// K1: block encode for Hopper (sm_90a).
//
// Replaces huffman_tpu/ops/pallas/encode.py:716 encode_blocks_pallas and its
// kernel _encode_kernel.  That kernel builds each block's stream with a
// log-depth merge tree of lane gathers, because Mosaic has neither a deep
// per-lane gather nor atomics.  Hopper has both: a block is a row for the
// row encoder in common.cuh, the 256-entry code table sits in shared memory
// and the codes go into a shared-memory copy of the block's output words.
//
// What bounds it on the card: device memory, one read of the input and one
// write of the (NB, cap) output rows, zeros included: 2 bytes a byte at the
// default capacity of 8 bits a byte.  The first design (a CTA per block,
// kept below) ran at 21% of that bound, held back by latency: four barriers
// a block, one 4-byte load per thread waiting behind them, and atomics for
// every placement.  encode_rows_warp (common.cuh) takes a warp per block,
// keeps the next blocks in flight by cp.async, and places a lane's codes as
// one bit run of whole words; see the note there.
//
// Routes, chosen by huff_encode_blocks from the shape: blocks that are a
// multiple of 16 bytes and at most ENC_WARP_MAX_BYTES (1024), at a 16-byte
// aligned address, with at most ENC_WARP_MAX_CAP (1024) words of capacity,
// go to encode_rows_warp; the main path's 1 KiB blocks at 256 words do.
// Every other shape goes to encode_rows_cta, which takes any block a
// multiple of 4 bytes long at any capacity: it walks a block in chunks of
// up to 1024 words, and stages the output in shared memory up to
// CTA_MAX_STAGED words (200 KiB) or ORs it into device memory beyond.

#include "common.cuh"

namespace {

// OR the bits of v (left-aligned: bit 63 goes first) into buf at bit `pos`.
// Words at or past `cap` are dropped.  Every shift stays within [0, 63].
__device__ __forceinline__ void put_bits(uint32_t* buf, uint32_t cap,
                                         uint32_t pos, uint64_t v) {
  const uint32_t w = pos >> 5, o = pos & 31;
  const uint32_t a = (uint32_t)(v >> (32 + o));
  const uint32_t b = (uint32_t)(v >> o);
  const uint32_t c = o ? (uint32_t)(v << (32 - o)) : 0u;
  if (a && w < cap) atomicOr(&buf[w], a);
  if (b && w + 1 < cap) atomicOr(&buf[w + 1], b);
  if (c && w + 2 < cap) atomicOr(&buf[w + 2], c);
}

// Most words a block's output may have to be staged in shared memory.
constexpr int CTA_MAX_STAGED = 200 * 1024 / 4;
constexpr int CTA_MAX_THREADS = 1024;

// A CTA of min(ceil(bw / 32) * 32, CTA_MAX_THREADS) threads walks the
// blocks blockIdx.x, blockIdx.x + gridDim.x, ...; a block of bw words is
// taken in chunks of blockDim.x words, thread t encoding bytes 4w .. 4w + 3
// of the block, the little-endian bytes of its input word w = chunk start
// + t.  Each chunk's codes go MSB-first into the block's cap output words
// at the block's running bit cursor, placed by a CTA-wide exclusive scan of
// the per-thread bit counts and atomicOr.  With STAGED the output words sit
// in shared memory and are stored coalesced once the block is done;
// without it (cap > CTA_MAX_STAGED) the kernel zeroes the block's output
// row in device memory and ORs into it there.
template <bool STAGED>
__global__ void __launch_bounds__(CTA_MAX_THREADS)
encode_rows_cta(const uint32_t* __restrict__ words,
                                const uint32_t* __restrict__ codes,
                                const int32_t* __restrict__ lengths,
                                const int32_t* __restrict__ valid,
                                uint32_t* __restrict__ out,
                                int32_t* __restrict__ bits_out, long long nb,
                                int bw, int cap) {
  extern __shared__ uint32_t s_out[];      // the block's cap output words
  __shared__ uint32_t s_tab[256];          // (code << 5) | length
  __shared__ uint32_t s_warp[32];          // per-warp sums, then their scan
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  for (int i = t; i < 256; i += blockDim.x)
    s_tab[i] = (codes[i] << 5) | (uint32_t)lengths[i];
  __syncthreads();

  for (long long b = blockIdx.x; b < nb; b += gridDim.x) {
    uint32_t* buf = STAGED ? s_out : out + b * cap;
    for (int i = t; i < cap; i += blockDim.x) buf[i] = 0u;
    const int nvalid = valid[b];
    uint32_t cursor = 0;                   // the block's bits so far
    int any_miss = 0;
    for (int c = 0; c < bw; c += blockDim.x) {
      const int wi = c + t;                // the thread's input word
      const uint32_t w = wi < bw ? words[b * bw + wi] : 0u;
      uint32_t lens[4], cds[4], total = 0;
      bool miss = false;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t e = s_tab[(w >> (8 * k)) & 255u];
        const bool live = wi < bw && 4 * wi + k < nvalid;
        lens[k] = live ? (e & 31u) : 0u;
        cds[k] = e >> 5;
        miss |= live && lens[k] == 0;
        total += lens[k];
      }

      // Chunk-wide exclusive scan of `total`.  The first barrier also makes
      // the zeroed output visible before any atomicOr.
      const uint32_t incl = warp_inclusive_scan(total);
      if (lane == 31) s_warp[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        const uint32_t x = lane < nwarps ? s_warp[lane] : 0u;
        const uint32_t xi = warp_inclusive_scan(x);
        if (lane < nwarps) s_warp[lane] = xi;
      }
      any_miss |= __syncthreads_or(miss);
      const uint32_t start =
          cursor + (warp ? s_warp[warp - 1] : 0u) + incl - total;
      cursor += s_warp[nwarps - 1];

      if (total > 0 && total <= 64) {
        // the thread's four codes fit one 64-bit accumulator
        uint64_t acc = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (lens[k]) acc = (acc << lens[k]) | cds[k];
        put_bits(buf, cap, start, acc << (64 - total));
      } else if (total > 64) {
        // codes longer than 16 bits: place them one at a time
        uint32_t p = start;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (lens[k]) {
            put_bits(buf, cap, p, (uint64_t)cds[k] << (64 - lens[k]));
            p += lens[k];
          }
        }
      }
      __syncthreads();  // s_warp is reused by the next chunk
    }
    if (STAGED)
      for (int i = t; i < cap; i += blockDim.x) out[b * cap + i] = s_out[i];
    if (t == 0)
      bits_out[b] = (int32_t)(cursor | (any_miss ? MISS_FLAG : 0u));
    __syncthreads();    // s_out is reused by the next block
  }
}

template <bool STAGED>
int launch_rows_cta(const void* words, const void* codes, const void* lengths,
                    const void* valid, void* out, void* bits, long long nb,
                    int bw, int cap, cudaStream_t s) {
  auto kernel = encode_rows_cta<STAGED>;
  const int threads =
      bw < CTA_MAX_THREADS ? (bw + 31) / 32 * 32 : CTA_MAX_THREADS;
  const size_t smem = STAGED ? (size_t)cap * sizeof(uint32_t) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = resident_grid(kernel, threads, smem, nb);
  kernel<<<grid, threads, smem, s>>>(
      (const uint32_t*)words, (const uint32_t*)codes,
      (const int32_t*)lengths, (const int32_t*)valid, (uint32_t*)out,
      (int32_t*)bits, nb, bw, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// `blocks` is (nb, block_bytes) bytes at a 4-byte aligned address;
// block_bytes a positive multiple of 4 and cap positive, with every
// block's bits below 2**31.
HUFF_API int huff_encode_blocks(const void* blocks, const void* codes,
                                const void* lengths, const void* valid,
                                void* out, void* bits, long long nb,
                                int block_bytes, int cap, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int bb = block_bytes;
  const bool warp_route = bb % 16 == 0 && bb <= ENC_WARP_MAX_BYTES &&
                          cap <= ENC_WARP_MAX_CAP &&
                          (reinterpret_cast<uintptr_t>(blocks) & 15) == 0;
  if (!warp_route)
    return (cap <= CTA_MAX_STAGED ? launch_rows_cta<true>
                                  : launch_rows_cta<false>)(
        blocks, codes, lengths, valid, out, bits, nb, bb / 4, cap, s);
  // a warp per block, W words a lane: the least W with 32 W >= the block
  const int W = bb <= 128 ? 1 : bb <= 256 ? 2 : bb <= 512 ? 4 : 8;
  auto launch = W == 1   ? launch_rows_warp<1, 1, false>
                : W == 2 ? launch_rows_warp<2, 1, false>
                : W == 4 ? launch_rows_warp<4, 1, false>
                         : launch_rows_warp<8, 1, false>;
  return launch(blocks, codes, lengths, valid, out, bits, nullptr, nb, bb,
                cap, s);
}

HUFF_API const char* huff_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
