// K1: block encode for Hopper (sm_90a).
//
// Replaces huffman_tpu/ops/pallas/encode.py encode_blocks_pallas and its
// kernel _encode_kernel.  That kernel builds each block's stream with a
// log-depth merge tree of lane gathers, because Mosaic has neither a deep
// per-lane gather nor atomics.  Hopper has both, so this kernel takes the
// shape of the original CUDA encoder: the 256-entry code table in shared
// memory, one thread per 4 input bytes, a block-wide exclusive scan of the
// per-thread bit counts (warp shuffles), and atomicOr of each thread's codes
// into a shared-memory copy of the block's output words, stored coalesced
// once the block is done.  The kernel, encode_rows_kernel, is in
// common.cuh: K5 (wide_encode.cu) runs the same code on 256-byte rows.
//
// What bounds it on the card: device memory moves one read of the input and
// one write of the (NB, cap) output, 2 bytes per input byte at the default
// 8 bits/byte capacity.  On chip, each block pays two barriers for the scan
// and up to three shared-memory atomics per thread.  A CTA walks many data
// blocks, so the code table is loaded once per CTA and not once per block.

#include "common.cuh"

HUFF_API int huff_encode_blocks(const void* words, const void* codes,
                                const void* lengths, const void* valid,
                                void* out, void* bits, long long nb, int bw,
                                int cap, int grid, void* stream) {
  return launch_encode_rows<false>(words, codes, lengths, valid, out, bits,
                                   nullptr, nb, bw, cap, grid, stream);
}

HUFF_API const char* huff_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
