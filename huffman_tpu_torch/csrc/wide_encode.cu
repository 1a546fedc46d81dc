// K5: wide-format substream encode for Hopper (sm_90a).
//
// Replaces huffman_tpu/wide.py _sub_encode_device and its Pallas kernel
// _kern: K1's merge tree stopped at level 8, giving each 256-byte
// substream of a 1 KiB block its own stream in a 128-word slot, plus `l2`,
// the bit count of every 4-byte item.  Stopping a merge tree early is how
// a TPU gets per-substream streams; on the card, a substream's stream is
// simply K1's output for a 256-byte block.  So this entry runs K1's row
// encoder (encode_rows_kernel in common.cuh) on rows of 256 bytes with 64
// threads, whose per-thread bit counts are exactly `l2`: one extra byte
// store per thread.  Slots are 8 * mcl + 2 words (the substream's bits and
// the two words past them that K7 may read), not 128.  Only the JAX
// package's exact tree (spec_chunks = 0) is ported; its narrow trees are
// Mosaic speed devices with the same output.
//
// What bounds it on the card: a CTA has only two warps, so 32 CTAs share
// an SM; each 256-byte row pays three barriers and writes 4 * slot bytes of
// stream and 64 bytes of l2 (2.6 output bytes per input byte at mcl 12).

#include "common.cuh"

HUFF_API int huff_wide_sub_encode(const void* substreams, const void* codes,
                                  const void* lengths, const void* valid,
                                  void* streams, void* bits, void* l2,
                                  long long ns, int slot, int grid,
                                  void* stream) {
  // 256-byte rows: 64 threads of 4 bytes each
  return launch_encode_rows<true>(substreams, codes, lengths, valid, streams,
                                  bits, l2, ns, 64, slot, grid, stream);
}
