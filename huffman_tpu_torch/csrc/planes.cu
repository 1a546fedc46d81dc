// DFloat11's two byte planes of bf16 words (arXiv:2504.11651): the split
// of a bf16 tensor into its exponent bytes and its sign-mantissa bytes,
// and the merge back.  For each word w (sign bit 15, exponent bits 14..7,
// mantissa bits 6..0):
//   exponent byte       e = (w >> 7) & 0xFF
//   sign-mantissa byte  s = ((w >> 8) & 0x80) | (w & 0x7F)
//   merge               w = ((s & 0x80) << 8) | (e << 7) | (s & 0x7F)
//
// Replaces no TPU kernel: the JAX package codes opaque byte streams only.
// It exists so that a bf16 tensor in card memory is coded on the card, its
// exponent plane through the dense codec and its sign-mantissa plane kept
// raw (api.encode of a bf16 tensor, api.decode of a PlanesEncoded).
//
// Design: a resident grid strides over groups of 8 words.  A group's words
// move as one 16-byte access, and each plane's 8 bytes of it as one 8-byte
// access where the plane's address allows, else as 4-, 2- or 1-byte
// pieces: every group of a launch has the same alignment, so that branch
// is uniform (a plane inside a container, container.loads_device, lies at
// a 4-byte offset).  The word side is brought to a 16-byte address by a
// head of 0-7 words, and 0-7 words are left at the tail; threads 0-13 of
// the grid move those one word each.  A tensor at a 2-byte address that is
// not 16-byte aligned (a view into another) is read in place.
// What bounds it: device memory, 4 bytes a word (2 read and 2 written).
// The bit work is a few shifts a word.

#include "common.cuh"

namespace {

constexpr int PLANE_THREADS = 256;
constexpr int GROUP = 8;                    // words a thread moves at once
constexpr int EDGE = 2 * (GROUP - 1);       // at most head + tail words

__device__ __forceinline__ uint32_t exp_of(uint32_t w) {
  return (w >> 7) & 0xFFu;
}

__device__ __forceinline__ uint32_t sm_of(uint32_t w) {
  return ((w >> 8) & 0x80u) | (w & 0x7Fu);
}

__device__ __forceinline__ uint32_t word_of(uint32_t e, uint32_t s) {
  return ((s & 0x80u) << 8) | (e << 7) | (s & 0x7Fu);
}

// The widest access (8, 4, 2 or 1 bytes) that address p allows.
__host__ __device__ inline int align_of(const void* p) {
  const unsigned long long a = (unsigned long long)p;
  return (a & 7) == 0 ? 8 : (a & 3) == 0 ? 4 : (a & 1) == 0 ? 2 : 1;
}

// 8 bytes at p, little-endian, in accesses of `al` bytes (align_of).
__device__ __forceinline__ uint64_t load8(const uint8_t* p, int al) {
  if (al == 8) return *reinterpret_cast<const uint64_t*>(p);
  uint64_t v = 0;
  if (al == 4) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
    return (uint64_t)q[0] | ((uint64_t)q[1] << 32);
  }
  if (al == 2) {
    const uint16_t* q = reinterpret_cast<const uint16_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) v |= (uint64_t)q[i] << (16 * i);
    return v;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v |= (uint64_t)p[i] << (8 * i);
  return v;
}

// The 8 bytes of v, little-endian, to p in accesses of `al` bytes.
__device__ __forceinline__ void store8(uint8_t* p, uint64_t v, int al) {
  if (al == 8) {
    *reinterpret_cast<uint64_t*>(p) = v;
  } else if (al == 4) {
    uint32_t* q = reinterpret_cast<uint32_t*>(p);
    q[0] = (uint32_t)v;
    q[1] = (uint32_t)(v >> 32);
  } else if (al == 2) {
    uint16_t* q = reinterpret_cast<uint16_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = (uint16_t)(v >> (16 * i));
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = (uint8_t)(v >> (8 * i));
  }
}

// Index of the edge word that thread t moves (t < head + tail), else -1.
__device__ __forceinline__ long long edge_word(long long t, long long n,
                                               long long head,
                                               long long groups) {
  const long long body_end = head + groups * GROUP;
  if (t < head) return t;
  return t - head < n - body_end ? body_end + (t - head) : -1;
}

__global__ void __launch_bounds__(PLANE_THREADS)
    split_bf16_kernel(const uint16_t* __restrict__ words,
                      uint8_t* __restrict__ exp, uint8_t* __restrict__ sm,
                      long long n, long long head, long long groups,
                      int al_e, int al_s) {
  const long long tid = (long long)blockIdx.x * PLANE_THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * PLANE_THREADS;
  if (tid < EDGE) {
    const long long i = edge_word(tid, n, head, groups);
    if (i >= 0) {
      const uint32_t w = words[i];
      exp[i] = (uint8_t)exp_of(w);
      sm[i] = (uint8_t)sm_of(w);
    }
  }
  for (long long g = tid; g < groups; g += stride) {
    const long long i = head + g * GROUP;
    const uint4 v = *reinterpret_cast<const uint4*>(words + i);
    const uint32_t x[4] = {v.x, v.y, v.z, v.w};
    uint64_t e = 0, s = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t lo = x[k] & 0xFFFFu, hi = x[k] >> 16;
      e |= (uint64_t)(exp_of(lo) | (exp_of(hi) << 8)) << (16 * k);
      s |= (uint64_t)(sm_of(lo) | (sm_of(hi) << 8)) << (16 * k);
    }
    store8(exp + i, e, al_e);
    store8(sm + i, s, al_s);
  }
}

__global__ void __launch_bounds__(PLANE_THREADS)
    merge_bf16_kernel(const uint8_t* __restrict__ exp,
                      const uint8_t* __restrict__ sm,
                      uint16_t* __restrict__ words, long long n,
                      long long head, long long groups, int al_e, int al_s) {
  const long long tid = (long long)blockIdx.x * PLANE_THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * PLANE_THREADS;
  if (tid < EDGE) {
    const long long i = edge_word(tid, n, head, groups);
    if (i >= 0) words[i] = (uint16_t)word_of(exp[i], sm[i]);
  }
  for (long long g = tid; g < groups; g += stride) {
    const long long i = head + g * GROUP;
    const uint64_t e = load8(exp + i, al_e), s = load8(sm + i, al_s);
    uint32_t x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t e2 = (uint32_t)(e >> (16 * k)),
                     s2 = (uint32_t)(s >> (16 * k));
      x[k] = word_of(e2 & 0xFFu, s2 & 0xFFu) |
             (word_of((e2 >> 8) & 0xFFu, (s2 >> 8) & 0xFFu) << 16);
    }
    *reinterpret_cast<uint4*>(words + i) = make_uint4(x[0], x[1], x[2], x[3]);
  }
}

// The head (words before the first 16-byte address of the word side, at
// most n) and the whole groups after it.
void layout(const void* words, long long n, long long* head,
            long long* groups) {
  const long long h = (long long)((16 - ((unsigned long long)words & 15)) &
                                  15) / 2;
  *head = h < n ? h : n;
  *groups = (n - *head) / GROUP;
}

template <typename K>
int grid_for(K kernel, long long groups) {
  return resident_grid(kernel, PLANE_THREADS, 0,
                       (groups + EDGE + PLANE_THREADS - 1) / PLANE_THREADS);
}

}  // namespace

// Split n bf16 words (at a 2-byte address) into the exponent plane exp and
// the sign-mantissa plane sm, n bytes each, at any addresses.
HUFF_API int huff_split_bf16(const void* words, void* exp, void* sm,
                             long long n, void* stream) {
  long long head, groups;
  layout(words, n, &head, &groups);
  const uint8_t* e0 = (const uint8_t*)exp + head;
  const uint8_t* s0 = (const uint8_t*)sm + head;
  split_bf16_kernel<<<grid_for(split_bf16_kernel, groups), PLANE_THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const uint16_t*)words, (uint8_t*)exp, (uint8_t*)sm, n, head, groups,
      align_of(e0), align_of(s0));
  return (int)cudaGetLastError();
}

// Merge the planes exp and sm, n bytes each at any addresses, into n bf16
// words (at a 2-byte address).
HUFF_API int huff_merge_bf16(const void* exp, const void* sm, void* words,
                             long long n, void* stream) {
  long long head, groups;
  layout(words, n, &head, &groups);
  const uint8_t* e0 = (const uint8_t*)exp + head;
  const uint8_t* s0 = (const uint8_t*)sm + head;
  merge_bf16_kernel<<<grid_for(merge_bf16_kernel, groups), PLANE_THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)exp, (const uint8_t*)sm, (uint16_t*)words, n, head,
      groups, align_of(e0), align_of(s0));
  return (int)cudaGetLastError();
}
