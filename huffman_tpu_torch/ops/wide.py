"""Plain PyTorch versions of the wide-format kernels (K5, K6+K7, K8).

The wide format (spec: golden/wide_codec.py) splits the stream into tiles
of 1024 substreams of 256 bytes.  Substream k of tile t owns bytes
[t*TILE_BYTES + 256k, +256), so row t*N_SUB + k of the stream viewed as
(NS, SUB_BYTES) rows IS tile t's substream k: every array below is laid
out by that row number (NS = NT * N_SUB rows).

  sub_encode       K5: each substream's own MSB-first stream and `l2`, the
                   bit count of each 4-byte item (huffman_tpu/wide.py
                   _sub_encode_device).
  schedule_counts  the 64-round reader recursion: per-round pull bases,
                   each tile's plane length (wide._schedule_counts) and
                   each substream's 64-bit pull mask.
  emit_planes      K6 relayout + K7 emit: every pulled word pair written to
                   its place in the container payload, from the pull masks
                   (ops/pallas/wide.py relayout_pallas, emit_planes_pallas).
  decode_tiles     K8: the 1024-lane reader (decode_wide_pallas).

The CUDA kernels (csrc/wide_encode.cu, wide_emit.cu, wide_decode.cu) are
held to these bit for bit.  Arithmetic is int64, words are int32 bit
patterns (ops/bitio.py).
"""

from __future__ import annotations

import torch

from ..golden.wide_codec import N_SUB, ROUNDS, SPR, SUB_BYTES, THRESH
from . import Counter, bitio
from .encode import encode_rows

ITEMS = SUB_BYTES // 4           # 4-byte items per substream (= ROUNDS)

# calls on CUDA tensors; the main path makes none (it launches the kernels)
cuda_calls = {name: Counter() for name in
              ("sub_encode", "schedule_counts", "emit_planes",
               "decode_tiles")}


def _count(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        cuda_calls[name].n += 1


def substream_valid(tile_bytes: torch.Tensor) -> torch.Tensor:
    """(NT,) bytes per tile -> (NT, N_SUB) int64 bytes per substream."""
    k = torch.arange(N_SUB, dtype=torch.int64, device=tile_bytes.device)
    return (tile_bytes.to(torch.int64)[:, None] - SUB_BYTES * k).clamp(
        0, SUB_BYTES)


def pull_mask(avail: torch.Tensor, n_k: torch.Tensor, j: int,
              mcl: int) -> torch.Tensor:
    """The spec's pull rule for round j: substream k pulls a word pair iff
    it has symbols left, fewer than THRESH bits buffered, and fewer than
    the remaining symbols could need (mcl is the codebook's actual max)."""
    rem = n_k - SPR * j
    return (rem > 0) & (avail < THRESH) & (avail < mcl * rem)


def sub_encode(substreams: torch.Tensor, codes: torch.Tensor,
               lengths: torch.Tensor, valid: torch.Tensor, slot: int):
    """K5: encode every substream on its own.

    Args:
      substreams: (NS, SUB_BYTES) uint8.
      codes, lengths: (256,) int32 codebook (lengths <= 12).
      valid: (NS,) int32 real bytes of each substream.
      slot: words kept per substream; 8 * mcl + 2 holds every bit plus the
        two words past them that the emit may read.

    Returns:
      streams: (NS, slot) int32, MSB-first from word 0, zero past the bits.
      bits: (NS,) int32 bit count, with bit 31 set where a valid byte has
        no code (ops.encode.MISS_FLAG).
      l2: (NS, ITEMS) uint8, the bits of 4-byte item i (bytes 4i..4i+3).
    """
    _count("sub_encode", substreams)
    streams, bits = encode_rows(substreams, codes, lengths, valid, slot)
    ns = substreams.shape[0]
    L = lengths.to(torch.int64)[substreams.to(torch.int64)]
    live = (torch.arange(SUB_BYTES, device=L.device)[None, :]
            < valid.to(torch.int64)[:, None])
    l2 = torch.where(live, L, 0).view(ns, ITEMS, 4).sum(dim=2)
    return streams, bits, l2.to(torch.uint8)


def schedule_counts(l2: torch.Tensor, tile_bytes: torch.Tensor, mcl: int):
    """The reader schedule of every tile, from the item bit counts alone.

    Args:
      l2: (NS, ITEMS) uint8 from sub_encode.
      tile_bytes: (NT,) int32 real bytes of each tile.
      mcl: the codebook's actual max code length.

    Returns bases (NT, ROUNDS) int32, the pulls before each round;
    tile_words (NT,) int32, each tile's plane length (its total pulls); and
    masks (NS,) int64, bit j of substream k's set iff it pulls in round j
    (bit 63 is the sign bit).
    """
    _count("schedule_counts", l2)
    nt = tile_bytes.shape[0]
    n_k = substream_valid(tile_bytes)
    lens = l2.to(torch.int64).view(nt, N_SUB, ITEMS)
    avail = torch.zeros_like(n_k)
    masks = torch.zeros_like(n_k)
    cnts = []
    for j in range(ROUNDS):
        pull = pull_mask(avail, n_k, j, mcl)
        cnts.append(pull.sum(dim=1))
        masks = masks | (pull.to(torch.int64) << j)
        avail = avail + 64 * pull - lens[:, :, j]
    cnts = torch.stack(cnts, dim=1)
    bases = torch.cumsum(cnts, dim=1) - cnts
    return (bases.to(torch.int32), cnts.sum(dim=1).to(torch.int32),
            masks.view(-1))


def emit_planes(streams: torch.Tensor, masks: torch.Tensor,
                bases: torch.Tensor, tile_words: torch.Tensor,
                offsets: torch.Tensor, n_words: int) -> torch.Tensor:
    """K6 + K7: the container payload.

    Tile t's payload starts at word offsets[t] and holds plane P0, then
    plane P1, each tile_words[t] words.  In round j the substreams that
    pull, ranked in increasing k, take plane positions bases[t, j] + rank;
    a pull moves the substream's next two stream words, the first to P0
    and the second to P1.

    Args: streams from sub_encode; masks, bases, tile_words from
      schedule_counts; offsets (NT,) int64; n_words, the payload length
      (sum of 2 * tile_words).
    Returns (n_words,) int32.
    """
    _count("emit_planes", streams)
    nt = bases.shape[0]
    slot = streams.shape[1]
    dev = streams.device
    words = bitio.to_u32(streams).view(nt, N_SUB, slot)
    m = masks.to(torch.int64).view(nt, N_SUB)
    start = offsets.to(torch.int64)[:, None]
    tw = tile_words.to(torch.int64)[:, None]
    wcur = torch.zeros_like(m)
    out = torch.zeros(n_words, dtype=torch.int64, device=dev)
    for j in range(ROUNDS):
        pull = ((m >> j) & 1).bool()
        rank = torch.cumsum(pull, dim=1) - pull.to(torch.int64)
        dst = start + bases.to(torch.int64)[:, j:j + 1] + rank
        for half in (0, 1):
            w = wcur + half
            val = torch.gather(words, 2, w.clamp(max=slot - 1)[:, :, None])
            val = torch.where(w < slot, val[:, :, 0], 0)
            out[(dst + half * tw)[pull]] = val[pull]
        wcur = wcur + 2 * pull
    return bitio.to_i32(out)


def decode_tiles(payload: torch.Tensor, offsets: torch.Tensor,
                 tile_words: torch.Tensor, bases: torch.Tensor,
                 tile_bytes: torch.Tensor, table: torch.Tensor,
                 mcl: int) -> torch.Tensor:
    """K8: decode tiles of a wide payload.

    Each substream's pulled word pairs, in pull order, are its own
    bitstream, so this version keeps each substream's pulled words and a
    bit cursor into them (the kernel keeps a 128-bit buffer instead); bits
    not yet pulled read as zero in both.

    Args:
      payload: (NW,) int32 words holding the tiles; reads past it see 0.
      offsets: (NT,) int64 word where each tile's P0 begins.
      tile_words, tile_bytes: (NT,) int32; bases: (NT, ROUNDS) int32.
      table: (2**mcl,) int16 entries (symbol << 8) | length
        (ops.decode.table_entries at mcl bits).
      mcl: the codebook's actual max code length: the table's width and
        the pull rule's.
    Returns (NT, N_SUB * SUB_BYTES) uint8, zero past each tile's bytes.
    """
    _count("decode_tiles", payload)
    dev = payload.device
    nt = tile_bytes.shape[0]
    # the zero word appended at `last` stands for every word past the end
    p = torch.cat([bitio.to_u32(payload),
                   torch.zeros(1, dtype=torch.int64, device=dev)])
    last = p.numel() - 1
    tab = table.to(torch.int64) & 0xFFFF
    syms, lens = tab >> 8, tab & 0xFF
    n_k = substream_valid(tile_bytes)
    start = offsets.to(torch.int64)[:, None]
    tw = tile_words.to(torch.int64)[:, None]
    # at most one pull a round: 2 * ROUNDS words, and one more for the
    # window that straddles the last of them
    sub_words = torch.zeros(nt, N_SUB, 2 * ROUNDS + 2, dtype=torch.int64,
                            device=dev)
    pulls = torch.zeros_like(n_k)
    pos = torch.zeros_like(n_k)
    out = torch.zeros(nt, N_SUB, SUB_BYTES, dtype=torch.uint8, device=dev)
    for j in range(ROUNDS):
        pull = pull_mask(64 * pulls - pos, n_k, j, mcl)
        rank = torch.cumsum(pull, dim=1) - pull.to(torch.int64)
        src = start + bases.to(torch.int64)[:, j:j + 1] + rank
        for half in (0, 1):
            w = p[(src + half * tw).clamp(max=last)]
            sub_words.scatter_(2, (2 * pulls + half)[:, :, None],
                               torch.where(pull, w, 0)[:, :, None])
        pulls = pulls + pull
        for u in range(SPR):
            s = SPR * j + u
            wi = (pos >> 5)[:, :, None]
            w0 = torch.gather(sub_words, 2, wi)[:, :, 0]
            w1 = torch.gather(sub_words, 2, wi + 1)[:, :, 0]
            win = bitio.extract_window(w0, w1, pos & 31) >> (32 - mcl)
            act = s < n_k
            out[:, :, s] = torch.where(act, syms[win], 0).to(torch.uint8)
            pos = pos + torch.where(act, lens[win], 0)
    return out.view(nt, N_SUB * SUB_BYTES)
