// Op-cost calibration for the row encoders (K1, K5) on one GPU.
//
// Each kernel runs a chain of n dependent operations of one kind in one
// CTA, so its time over n is the latency of one operation: a 256-entry
// shared-memory table lookup, one warp shuffle step, one shared-memory
// atomicOr, one CTA barrier (256 threads, K1's first CTA), and an integer
// multiply-add for scale.  op_cost_ns times a chain of n and of 2n with CUDA
// events and returns the difference over n, which cancels the launch.
// Built and run by scripts/ablate_encoders.py (variant op_costs):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//        -o libopcosts.so scripts/op_costs.cu

#include <cuda_runtime.h>
#include <stdint.h>

#define OP_API extern "C" __attribute__((visibility("default")))

namespace {

enum Op { LOOKUP = 0, SHUFFLE = 1, ATOMIC = 2, BARRIER = 3, IMAD = 4 };

__global__ void chain(int op, int n, uint32_t* out) {
  __shared__ uint32_t s[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    s[i] = (i * 97u + 31u) & 255u;        // a permutation: lookups chain
  __syncthreads();
  uint32_t x = threadIdx.x;
  if (op == LOOKUP) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = s[x];
  } else if (op == SHUFFLE) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x += __shfl_up_sync(0xffffffffu, x, 1);
  } else if (op == ATOMIC) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = atomicOr(&s[threadIdx.x & 255], x) + 1u;
  } else if (op == BARRIER) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      __syncthreads();
      x += 1u;
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < n; ++i) x = x * 3u + 1u;
  }
  out[threadIdx.x] = x;
}

float chain_ms(int op, int n, int threads, uint32_t* out, cudaEvent_t a,
               cudaEvent_t b) {
  chain<<<1, threads>>>(op, n, out);      // warm-up
  cudaEventRecord(a);
  chain<<<1, threads>>>(op, n, out);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}

}  // namespace

// ns per operation of kind `op` (see Op) over chains of n and 2n; returns a
// CUDA error code, 0 on success.
OP_API int op_cost_ns(int op, int n, float* ns) {
  uint32_t* out = nullptr;
  cudaError_t e = cudaMalloc(&out, 256 * sizeof(uint32_t));
  if (e != cudaSuccess) return (int)e;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  const int threads = op == BARRIER ? 256 : 32;
  const float t1 = chain_ms(op, n, threads, out, a, b);
  const float t2 = chain_ms(op, 2 * n, threads, out, a, b);
  *ns = (t2 - t1) * 1e6f / (float)n;
  e = cudaGetLastError();
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  cudaFree(out);
  return (int)e;
}
