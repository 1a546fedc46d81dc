"""NumPy golden codec for the WIDE (interleaved) container format, v2.

The port's own copy of the format specification
(huffman_tpu/golden/wide_codec.py, numpy only): the port reads nothing of
the JAX package, and tests/test_torch_golden_copies.py holds the two
copies to the same results.  The CUDA kernels (csrc/wide_*.cu) and their
plain versions (ops/wide.py) are verified bit-for-bit against it.

Why a second format: the reference's dense bit-concatenated stream
(cpuencode.cpp:21-45 convention) is ideal for sequential CPUs but
hostile to vector decode — every lane would need random access into its
own block's bitstream.  The wide format interleaves codeword bits at WORD
granularity in exactly the order a 1024-lane vector reader consumes them,
so decode refills are one contiguous window read per step, as in the
interleaved-stream layouts of production SIMD/GPU entropy codecs.

Format v2 (container version 3)
-------------------------------
v1 ran 256 reader rounds/tile (1 symbol each) with single-word pulls; on
TPU the per-round vector cost is fixed, so v2 quarters the round count:

* The byte stream is split into TILES of TILE_BYTES = 262144 bytes
  (N_SUB = 1024 substreams x SUB_BYTES = 256 bytes).  Substream k of a
  tile owns bytes [256k, 256(k+1)); in a partial (last) tile it holds
  n_k = clamp(n_tile - 256k, 0, 256) bytes.
* Symbols use a shared canonical Huffman codebook, max length <= MAXLEN.
* Tile payload: TWO equal-length word PLANES P0 and P1 (stored
  concatenated, P0 then P1).  A vector reader runs ROUNDS = 64 rounds;
  each round j:
    1. every substream k with (SPR*j < n_k) pulls ONE WORD PAIR iff
           avail_k < THRESH  and  avail_k < mcl * (n_k - SPR*j)
       where mcl is the codebook's actual max code length (the second
       clause suppresses tail over-pulls: once the buffer provably covers
       every remaining symbol, no more words are read — decoder-
       replicable because it only uses the codebook and n_k).  The pair
       is P0[p] and P1[p] at the substream's pull index p (pull indices
       are assigned in increasing k within a round, and accumulate
       across rounds).  The 64 bits (P0 word first) append to the
       substream's bit buffer at position avail_k; avail_k += 64.
       avail_k starts at 0.
    2. it then decodes SPR = 4 symbols: for u in 0..3, if SPR*j+u < n_k,
       consume one codeword MSB-first (avail_k -= len).
* Invariants (THRESH = 48 >= SPR*MAXLEN, refill 64 > THRESH):
  avail covers every symbol decoded in the round (>= 48 buffered, or
  >= mcl * remaining), and avail <= 111 always — a 128-bit lane buffer
  suffices.
* The container records, per tile: the plane length in words (= total
  pulls) and the 64 per-round pull-index bases (exclusive cumsum of
  per-round pull counts) — the latter lets the decoder skip recomputing
  the global pull cursor.
"""

from __future__ import annotations

import numpy as np

TILE_BYTES = 262144
SUB_BYTES = 256
N_SUB = TILE_BYTES // SUB_BYTES          # 1024
MAXLEN = 12
SPR = 4                                  # symbols decoded per round
ROUNDS = SUB_BYTES // SPR                # 64
THRESH = 48                              # pull when avail < THRESH


def _substream_views(tile: np.ndarray):
    """Pad a (<=TILE_BYTES,) tile to (N_SUB, SUB_BYTES) + valid counts."""
    n = tile.shape[0]
    buf = np.zeros(TILE_BYTES, np.uint8)
    buf[:n] = tile
    n_k = np.clip(n - np.arange(N_SUB) * SUB_BYTES, 0, SUB_BYTES)
    return buf.reshape(N_SUB, SUB_BYTES), n_k.astype(np.int64)


def substream_words(tile: np.ndarray, codes: np.ndarray,
                    lengths: np.ndarray) -> list[np.ndarray]:
    """Each substream's own bitstream as uint32 words (MSB-first)."""
    sub, n_k = _substream_views(np.ascontiguousarray(tile, np.uint8))
    lens = lengths[sub].astype(np.int64)
    cods = codes[sub].astype(np.uint64)
    out = []
    for k in range(N_SUB):
        nk = int(n_k[k])
        total = int(lens[k, :nk].sum())
        words = np.zeros((total + 31) // 32 + 2, np.uint64)
        cur = 0
        for j in range(nk):
            L = int(lens[k, j]); c = int(cods[k, j])
            base, sh = cur >> 5, cur & 31
            v = c << (64 - sh - L)
            words[base] |= (v >> 32) & 0xFFFFFFFF
            words[base + 1] |= v & 0xFFFFFFFF
            cur += L
        out.append(words.astype(np.uint32))
    return out


def encode_tile(tile: np.ndarray, codes: np.ndarray, lengths: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode one tile -> (P0 words, P1 words, round bases (ROUNDS,) i32).

    Reference simulation of the reader schedule (the spec)."""
    sub, n_k = _substream_views(np.ascontiguousarray(tile, np.uint8))
    lens = lengths[sub].astype(np.int64)
    sub_bits = substream_words(tile, codes, lengths)
    mcl = int(np.max(lengths))
    avail = np.zeros(N_SUB, np.int64)
    wcur = np.zeros(N_SUB, np.int64)
    p0, p1 = [], []
    bases = np.zeros(ROUNDS, np.int32)
    for j in range(ROUNDS):
        bases[j] = len(p0)
        active = (SPR * j) < n_k
        pull = active & (avail < THRESH) & (avail < mcl * (n_k - SPR * j))
        for k in np.flatnonzero(pull):
            w = sub_bits[k]
            c = int(wcur[k])
            p0.append(np.uint32(w[c] if c < len(w) else 0))
            p1.append(np.uint32(w[c + 1] if c + 1 < len(w) else 0))
            wcur[k] += 2
        avail = np.where(pull, avail + 64, avail)
        for u in range(SPR):
            s = SPR * j + u
            avail = avail - np.where(s < n_k, lens[:, s], 0)
    return (np.asarray(p0, np.uint32), np.asarray(p1, np.uint32), bases)


def decode_tile(p0: np.ndarray, p1: np.ndarray, n_tile: int,
                table_syms: np.ndarray, table_lens: np.ndarray,
                table_bits: int, mcl: int) -> np.ndarray:
    """Decode one tile's planes -> n_tile bytes (the reader specification).

    mcl must be the SAME max-code-length value the encoder used (the
    codebook's actual max length) — it enters the pull rule."""
    n_k = np.clip(n_tile - np.arange(N_SUB) * SUB_BYTES, 0, SUB_BYTES)
    hi = np.zeros(N_SUB, np.uint64)        # top 64 bits, MSB-aligned
    lo = np.zeros(N_SUB, np.uint64)        # next 64 bits
    avail = np.zeros(N_SUB, np.int64)
    out = np.zeros((N_SUB, SUB_BYTES), np.uint8)
    pos = 0
    pad = np.zeros(N_SUB * 2, np.uint32)
    p0 = np.concatenate([p0, pad]).astype(np.uint64)
    p1 = np.concatenate([p1, pad]).astype(np.uint64)
    for j in range(ROUNDS):
        active = (SPR * j) < n_k
        pull = active & (avail < THRESH) & (avail < mcl * (n_k - SPR * j))
        idxs = np.flatnonzero(pull)
        w64 = (p0[pos: pos + len(idxs)] << np.uint64(32)) \
            | p1[pos: pos + len(idxs)]
        pos += len(idxs)
        # insert 64 bits at bit position avail (<= 47) of the 128-bit
        # (hi, lo) pair; shift amounts are masked &63 so masked-out lanes
        # never evaluate an undefined uint64 shift
        a = avail[idxs].astype(np.uint64)
        hi[idxs] |= w64 >> a
        lo[idxs] |= np.where(
            a > 0, w64 << ((np.uint64(64) - a) & np.uint64(63)), 0
        ).astype(np.uint64)
        avail = np.where(pull, avail + 64, avail)
        for u in range(SPR):
            s = SPR * j + u
            act = s < n_k
            win = (hi >> np.uint64(64 - table_bits)).astype(np.int64)
            sym = table_syms[win]
            ln = np.where(act, table_lens[win].astype(np.int64), 0)
            out[:, s] = np.where(act, sym, 0)
            lnu = ln.astype(np.uint64)
            sh = (np.uint64(64) - lnu) & np.uint64(63)
            hi = np.where(ln > 0, (hi << lnu) | (lo >> sh), hi)
            lo = np.where(ln > 0, lo << lnu, lo)
            avail -= ln
    return out.reshape(-1)[:n_tile]


def encode(data, codes, lengths):
    """Encode a byte stream -> (list of (P0, P1, bases) per tile, n_bytes)."""
    arr = (np.frombuffer(data, np.uint8)
           if isinstance(data, (bytes, bytearray))
           else np.ascontiguousarray(data, np.uint8).reshape(-1))
    tiles = [arr[i: i + TILE_BYTES] for i in range(0, max(len(arr), 1),
                                                   TILE_BYTES)]
    return [encode_tile(t, codes, lengths) for t in tiles], arr.size


def decode(tile_planes, n_bytes: int, table_syms, table_lens,
           table_bits: int, mcl: int) -> np.ndarray:
    outs = []
    rem = n_bytes
    for (p0, p1, _bases) in tile_planes:
        n_t = min(rem, TILE_BYTES)
        outs.append(decode_tile(p0, p1, n_t, table_syms, table_lens,
                                table_bits, mcl))
        rem -= n_t
    return (np.concatenate(outs) if outs else np.zeros(0, np.uint8))[:n_bytes]
