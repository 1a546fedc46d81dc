// Shared declarations of the port's CUDA kernels.
//
// Every kernel has a plain C entry point, loaded with ctypes
// (huffman_tpu_torch/ops/cuda/_build.py): pointers and the CUDA stream
// arrive as void*, and the entry returns cudaGetLastError() after the
// launch so that a refused launch is reported where it happened.  Kernels
// allocate nothing; the Python wrappers allocate every buffer.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define HUFF_API extern "C" __attribute__((visibility("default")))

// Stream bit convention: bit i of the stream is bit (31 - (i & 31)) of
// word (i >> 5), i.e. MSB-first 32-bit words.
