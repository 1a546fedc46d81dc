// Golden CPU Huffman codec (bit-exactness oracle for the device pipeline).
//
// The port's own copy of huffman_tpu/golden/cpu_codec.cpp: the port
// compiles nothing of the JAX package, and tests/test_torch_golden_copies.py
// holds the two builds to the same streams.
//
// Native C++ replacement for the reference's sequential golden encoder
// `cpu_vlc_encode` (reference: cpuencode.cpp:13-46), extended with the
// decoder the reference lacks (SURVEY.md section 7, capability 10) and a
// histogram twin.  The bitstream convention matches the reference's:
// codewords are emitted MSB-first into the stream (cpuencode.cpp:32-40);
// bit i of the stream is bit (7 - (i & 7)) of byte (i >> 3).  Unlike the
// reference, symbols are consumed in natural byte order rather than the
// endianness-scrambled order produced by its uint32 reinterpretation
// (cpuencode.cpp:27-28); the oracle we verify against is this one.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstring>

extern "C" {

// Encode n bytes. codes[s] is the right-aligned codeword value of byte s,
// lens[s] its bit length (<= 24). `out` must have capacity
// ceil(n * max_len / 8) + 8 bytes. Returns the total number of bits written
// (out is zero-padded to the next byte).
uint64_t huff_encode_bytes(const uint8_t* in, uint64_t n,
                           const uint32_t* codes, const int32_t* lens,
                           uint8_t* out) {
  uint64_t acc = 0;
  int nbits = 0;
  uint64_t outpos = 0;
  uint64_t total_bits = 0;
  for (uint64_t i = 0; i < n; ++i) {
    const uint8_t s = in[i];
    const int L = lens[s];
    acc = (acc << L) | codes[s];
    nbits += L;
    total_bits += (uint64_t)L;
    while (nbits >= 8) {
      out[outpos++] = (uint8_t)(acc >> (nbits - 8));
      nbits -= 8;
    }
  }
  if (nbits > 0) {
    out[outpos++] = (uint8_t)(acc << (8 - nbits));
  }
  return total_bits;
}

// Decode n_out symbols from the bitstream `in`, starting at bit_offset.
// (tab_syms, tab_lens) is a single-level canonical decode table of
// 2**table_bits entries (see codebook.Codebook.decode_table). `in` must be
// readable for 4 bytes past the last consumed bit (callers pad).
// Returns the bit cursor after the last symbol, or UINT64_MAX on a corrupt
// stream (table length 0).
uint64_t huff_decode_bytes(const uint8_t* in, uint64_t bit_offset,
                           const uint8_t* tab_syms, const uint8_t* tab_lens,
                           int table_bits, uint8_t* out, uint64_t n_out) {
  uint64_t cur = bit_offset;
  for (uint64_t k = 0; k < n_out; ++k) {
    const uint64_t byte = cur >> 3;
    const int off = (int)(cur & 7);
    const uint32_t v = ((uint32_t)in[byte] << 24) | ((uint32_t)in[byte + 1] << 16) |
                       ((uint32_t)in[byte + 2] << 8) | (uint32_t)in[byte + 3];
    const uint32_t idx = (uint32_t)(((uint64_t)v << off) >> (32 - table_bits)) &
                         ((1u << table_bits) - 1u);
    const int L = tab_lens[idx];
    if (L == 0) return UINT64_MAX;
    out[k] = tab_syms[idx];
    cur += (uint64_t)L;
  }
  return cur;
}

// 256-bin byte histogram (oracle twin of the device histogram,
// reference: hist.cu:34-52 — minus its byte/element units bug, hist.cu:98).
void byte_histogram(const uint8_t* in, uint64_t n, uint64_t* hist256) {
  memset(hist256, 0, 256 * sizeof(uint64_t));
  // Four privatized accumulators to break the store-load dependency chain —
  // the CPU analogue of the reference's privatized shared-memory bins.
  uint64_t h0[256] = {0}, h1[256] = {0}, h2[256] = {0}, h3[256] = {0};
  uint64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    ++h0[in[i]];
    ++h1[in[i + 1]];
    ++h2[in[i + 2]];
    ++h3[in[i + 3]];
  }
  for (; i < n; ++i) ++h0[in[i]];
  for (int b = 0; b < 256; ++b) hist256[b] = h0[b] + h1[b] + h2[b] + h3[b];
}

}  // extern "C"
