// K5: wide-format substream encode for Hopper (sm_90a).
//
// Replaces huffman_tpu/wide.py:153 _sub_encode_device and its Pallas kernel
// _kern: K1's merge tree stopped at level 8, giving each 256-byte
// substream of a 1 KiB block its own stream in a 128-word slot, plus `l2`,
// the bit count of every 4-byte item.  Stopping a merge tree early is how
// a TPU gets per-substream streams; on the card a substream is simply a
// 256-byte row for K1's row encoder (encode_rows_warp in common.cuh), whose
// per-item bit counts are exactly `l2`.  Slots are 8 * mcl + 2 words (the
// substream's bits and the two words past them that K7 may read), not 128.
// Only the JAX package's exact tree (spec_chunks = 0) is ported; its narrow
// trees are Mosaic speed devices with the same output.
//
// What bounds it on the card: device memory, one read of the substreams and
// one write of the slot rows and l2, 2.6 output bytes an input byte at mcl
// 12.  The first design, K1's CTA per row on 64-thread CTAs, paid four
// barriers for every 256-byte row and ran at 27.5% of that bound.  Now a
// warp encodes a substream, lane l its bytes 8l .. 8l + 7 (two l2 items,
// stored as one 16-bit value), with the next substreams in flight by
// cp.async and no CTA barrier; see the note in common.cuh.

#include "common.cuh"

// `substreams` is (ns, 256) bytes at a 16-byte aligned address; slot in
// [1, 98].
HUFF_API int huff_wide_sub_encode(const void* substreams, const void* codes,
                                  const void* lengths, const void* valid,
                                  void* streams, void* bits, void* l2,
                                  long long ns, int slot, void* stream) {
  // 8 lanes a substream, 32 bytes each: four substreams a warp
  return launch_rows_warp<8, 4, true>(substreams, codes, lengths, valid,
                                      streams, bits, l2, ns, WIDE_SUB_BYTES,
                                      slot, (cudaStream_t)stream);
}
