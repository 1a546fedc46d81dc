// The v1 container's payload on the card: the byte swap between the
// stream's host-order words and the big-endian payload, and the CRC-32 of
// the payload bytes (zlib's: reflected polynomial 0xEDB88320, initial and
// final value ~0), in one pass.
//
// Replaces no TPU kernel: the JAX package swaps and takes the CRC on the
// host (huffman_tpu/container.py, numpy and zlib.crc32).  It exists so
// that a stream that lives in card memory becomes a container there, and
// back, without crossing to the host (container.dumps_device,
// container.loads_device).
//
// Direction: with host_order_in the source holds host-order words h and
// the destination gets the payload words (h's bytes MSB first); otherwise
// the source is the payload and the destination gets host-order words.
// The CRC is of the payload bytes either way, taken in the same pass.
//
// copy_crc32_kernel is the same pass without the swap, for the raw
// sign-mantissa plane that follows the stream in a container version 4
// (container.dumps_device, loads_device): the words are copied as they
// are (or, with no destination, only read), and the CRC may go on from
// one already on the card, the stream's, so that it is that of the stream
// and the plane together.  zlib's CRC of A B is (crc(A) + ~0) x^(8|B|) +
// raw(B) + ~0, so a start value only changes the affine term.
//
// Design: CRCs of chunks combined by multiplying by x^(8 len) mod P, as
// zlib's crc32_combine does.  Let raw(M) be the CRC with initial value 0
// and no final inversion; it is linear, raw(A B) = raw(A) x^(8|B|) + raw(B)
// over GF(2) mod P, leading zero bytes leave it unchanged, and zlib's CRC
// is raw(M) + ~0 x^(8|M|) + ~0.
//   1. The payload is padded in front with zero words (read as zeros, never
//      written) to whole chunks of CHUNK_WORDS words, so that every chunk
//      has the same length.  A warp takes chunk ch, ch + warps, ... .
//   2. A warp loads its chunk in 32 coalesced rows, writing each swapped
//      word straight out, and puts the payload words through a padded
//      shared-memory transpose, so that lane l holds row l: 32 consecutive
//      words.  Each lane runs the byte-wise table CRC over its 128 bytes;
//      the table is held once a lane (entry b of copy l at word 32 b + l),
//      so that no two lanes' lookups meet in a bank.
//   3. The lanes' CRCs are shifted by x^(8 * 128 * (31 - l)) and XORed
//      across the warp: the chunk's raw CRC.  A warp folds its chunks by
//      Horner's rule with the constant x^(8 * 4096 * warps), shifts the sum
//      to the end of the stream once, and XORs it into the output, which
//      the entry cleared; block 0 adds zlib's affine term.
// What bounds it: device memory, each payload byte read once and written
// once.  A word costs a load, a store, a swap, two shared-memory accesses
// of the transpose and four conflict-free table lookups; a chunk adds two
// 32-step GF(2) products a lane.

#include "common.cuh"

namespace {

constexpr uint32_t CRC_POLY = 0xEDB88320u;  // zlib's, bit-reflected
constexpr uint32_t X0 = 0x80000000u;        // x^0, bit-reflected
constexpr int CRC_THREADS = 256;
constexpr int CRC_WARPS = CRC_THREADS / 32;
constexpr int CRC_SEG = 32;                 // words a lane's CRC runs over
constexpr int CRC_ROW = CRC_SEG + 1;        // a transpose row, padded
constexpr long long CHUNK_WORDS = 32 * CRC_SEG;
constexpr int X2N = 64;                     // x^(2^k) for k < X2N
constexpr size_t CRC_SMEM =
    (256 * 32 + CRC_WARPS * 32 * CRC_ROW) * sizeof(uint32_t);

struct CrcConsts {
  uint32_t x2n[X2N];        // x^(2^k) mod P
  uint32_t lane_shift[32];  // x^(8 * 4 * CRC_SEG * (31 - l)) mod P
  uint32_t step;            // x^(8 * 4 * CHUNK_WORDS * warps) mod P
  uint32_t length;          // x^(8 n) mod P, n the payload bytes
  uint32_t affine;          // ~0 x^(8 n) + ~0
};

// a * b mod P, bit-reflected (zlib's multmodp).
__host__ __device__ inline uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t p = 0;
  for (int i = 0; i < 32; ++i) {
    p ^= b & (0u - ((a >> (31 - i)) & 1u));
    b = (b >> 1) ^ (CRC_POLY & (0u - (b & 1u)));
  }
  return p;
}

// x^(8 n) mod P (zlib's x2nmodp(n, 3)).
__host__ __device__ inline uint32_t x8nmodp(unsigned long long n,
                                            const uint32_t* x2n) {
  uint32_t p = X0;
  for (int k = 3; n; n >>= 1, ++k)
    if (n & 1) p = multmodp(x2n[k], p);
  return p;
}

// The pass over the chunks of one launch: each warp's chunks swapped (SWAP)
// or not and stored to dst (where given), and the XOR into *crc_out of
// their raw CRCs, each shifted to the end of the stream.  crc_of_dst: the
// CRC is of the stored words, else of the loaded ones.
template <bool SWAP>
__device__ __forceinline__ void crc_chunks(const uint32_t* __restrict__ src,
                                           uint32_t* __restrict__ dst,
                                           long long n_words, long long pad,
                                           long long n_chunks,
                                           bool crc_of_dst,
                                           uint32_t* __restrict__ crc_out,
                                           const CrcConsts& c) {
  extern __shared__ uint32_t smem[];
  uint32_t* table = smem;                   // table[32 b + l] = T[b]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 256 * 32; i += CRC_THREADS) {
    uint32_t t = (uint32_t)i >> 5;
#pragma unroll
    for (int k = 0; k < 8; ++k) t = (t >> 1) ^ (CRC_POLY & (0u - (t & 1u)));
    table[i] = t;
  }
  uint32_t* tile = smem + 256 * 32 + warp * 32 * CRC_ROW;
  __syncthreads();

  const bool store = SWAP || dst != nullptr;
  const long long warps = (long long)gridDim.x * CRC_WARPS;
  const uint32_t shift = c.lane_shift[lane];
  long long last = -1;
  uint32_t acc = 0;
  for (long long ch = (long long)blockIdx.x * CRC_WARPS + warp; ch < n_chunks;
       ch += warps) {
    const long long w0 = ch * CHUNK_WORDS - pad;   // may be negative: padding
    uint32_t x[32];                                // all 32 rows in flight
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const long long r = w0 + 32 * k + lane;
      x[k] = r >= 0 && r < n_words ? __ldcs(src + r) : 0u;
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const long long r = w0 + 32 * k + lane;
      const uint32_t y = SWAP ? __byte_perm(x[k], 0, 0x0123) : x[k];
      if (store && r >= 0 && r < n_words) __stcs(dst + r, y);
      tile[k * CRC_ROW + lane] = crc_of_dst ? y : x[k];  // row k: lane k's
    }
    __syncwarp();
    uint32_t crc = 0;
#pragma unroll 8
    for (int j = 0; j < CRC_SEG; ++j) {
      crc ^= tile[lane * CRC_ROW + j];             // its bytes, in order
#pragma unroll
      for (int b = 0; b < 4; ++b)
        crc = table[((crc & 255u) << 5) + lane] ^ (crc >> 8);
    }
    __syncwarp();                                  // the tile is reused
    crc = multmodp(shift, crc);
#pragma unroll
    for (int o = 16; o; o >>= 1) crc ^= __shfl_xor_sync(0xffffffffu, crc, o);
    acc = multmodp(c.step, acc) ^ crc;
    last = ch;
  }
  if (last >= 0 && lane == 0) {
    const unsigned long long after =
        (unsigned long long)(n_chunks - 1 - last) * CHUNK_WORDS * 4;
    atomicXor(crc_out, multmodp(x8nmodp(after, c.x2n), acc));
  }
}

__global__ void __launch_bounds__(CRC_THREADS)
    swap_crc32_kernel(const uint32_t* __restrict__ src,
                      uint32_t* __restrict__ dst, long long n_words,
                      long long pad, long long n_chunks, int host_order_in,
                      uint32_t* __restrict__ crc_out, const CrcConsts c) {
  crc_chunks<true>(src, dst, n_words, pad, n_chunks, host_order_in, crc_out,
                   c);
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicXor(crc_out, c.affine);
}

__global__ void __launch_bounds__(CRC_THREADS)
    copy_crc32_kernel(const uint32_t* __restrict__ src,
                      uint32_t* __restrict__ dst, long long n_words,
                      long long pad, long long n_chunks,
                      const uint32_t* __restrict__ start,
                      uint32_t* __restrict__ crc_out, const CrcConsts c) {
  crc_chunks<false>(src, dst, n_words, pad, n_chunks, false, crc_out, c);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicXor(crc_out, start ? multmodp(c.length, *start ^ ~0u) ^ ~0u
                             : c.affine);
}

}  // namespace

namespace {

// The constants of a launch over n_words words, and its grid.
template <typename K>
int crc_setup(K kernel, long long n_words, CrcConsts* c, long long* pad,
              long long* n_chunks) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CRC_SMEM);
  if (e != cudaSuccess) return -(int)e;
  c->x2n[0] = X0 >> 1;                           // x^1
  for (int k = 1; k < X2N; ++k)
    c->x2n[k] = multmodp(c->x2n[k - 1], c->x2n[k - 1]);
  for (int l = 0; l < 32; ++l)
    c->lane_shift[l] = x8nmodp(4ull * CRC_SEG * (31 - l), c->x2n);
  *n_chunks = (n_words + CHUNK_WORDS - 1) / CHUNK_WORDS;
  *pad = *n_chunks * CHUNK_WORDS - n_words;
  const int grid = resident_grid(kernel, CRC_THREADS, CRC_SMEM,
                                 (*n_chunks + CRC_WARPS - 1) / CRC_WARPS);
  c->step = x8nmodp(4ull * CHUNK_WORDS * grid * CRC_WARPS, c->x2n);
  c->length = x8nmodp(4ull * n_words, c->x2n);
  c->affine = multmodp(c->length, ~0u) ^ ~0u;
  return grid;
}

}  // namespace

// Swap n_words 32-bit words of src into dst (both 4-byte aligned, not
// overlapping) and write the CRC-32 of the payload bytes (dst's with
// host_order_in, src's without) to *crc (4-byte aligned).
HUFF_API int huff_swap_crc32(const void* src, void* dst, long long n_words,
                             int host_order_in, void* crc, void* stream) {
  CrcConsts c;
  long long pad, n_chunks;
  const int grid = crc_setup(swap_crc32_kernel, n_words, &c, &pad, &n_chunks);
  if (grid < 0) return -grid;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(crc, 0, sizeof(uint32_t), s);
  if (e != cudaSuccess) return (int)e;
  swap_crc32_kernel<<<grid, CRC_THREADS, CRC_SMEM, s>>>(
      (const uint32_t*)src, (uint32_t*)dst, n_words, pad, n_chunks,
      host_order_in, (uint32_t*)crc, c);
  return (int)cudaGetLastError();
}

// Copy n_words 32-bit words of src into dst as they are (dst null: only
// read them), and write to *crc the CRC-32 of their bytes, or, with start,
// of the bytes whose CRC-32 is *start followed by theirs (zlib's
// crc32(src, *start)).  All 4-byte aligned; src and dst do not overlap,
// and crc is not start.
HUFF_API int huff_copy_crc32(const void* src, void* dst, long long n_words,
                             const void* start, void* crc, void* stream) {
  CrcConsts c;
  long long pad, n_chunks;
  const int grid = crc_setup(copy_crc32_kernel, n_words, &c, &pad, &n_chunks);
  if (grid < 0) return -grid;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(crc, 0, sizeof(uint32_t), s);
  if (e != cudaSuccess) return (int)e;
  copy_crc32_kernel<<<grid, CRC_THREADS, CRC_SMEM, s>>>(
      (const uint32_t*)src, (uint32_t*)dst, n_words, pad, n_chunks,
      (const uint32_t*)start, (uint32_t*)crc, c);
  return (int)cudaGetLastError();
}
