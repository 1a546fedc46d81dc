"""Plain reference of the wide codec (container version 3), in PyTorch.

The format, as its specification states it (the project's
golden/wide_codec.py): bytes in tiles of 262,144, each tile 1024
substreams of 256 bytes; substream k holds n_k = clamp(n_tile - 256 k, 0,
256) bytes, and its own stream is its bytes' canonical codes, MSB-first.
A reader runs 64 rounds; in round j every substream with 4 j < n_k whose
buffer holds avail < 48 bits and avail < mcl (n_k - 4 j) pulls its next
two words, P0 then P1 at its pull index (indices in increasing k within a
round, counting on across rounds), then consumes 4 codes.  mcl is the
book's longest code.  A tile stores plane P0, then P1, each of its pull
count in words, and its 64 round bases (the pulls before each round).
The container holds a header, the 256 code lengths, each tile's plane
words (u32), its bases (u16), the payload words little-endian, and the
CRC-32 of the payload bytes.  The book is built from all byte counts.

Every step runs on all substreams of a group of tiles at once.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from . import bits as B
from . import codebook
from .dense import HEADER, MAGIC, FLAG_CRC32, byte_counts, cdiv

VERSION = 3
TILE_BYTES, SUB_BYTES, N_SUB = 262144, 256, 1024
ROUNDS, SPR, THRESH = 64, 4, 48
TILES_A_STEP = 128


def choose_lengths(x: torch.Tensor, config: dict):
    return codebook.code_lengths(byte_counts(x), config["max_code_len"],
                                 config["narrow_tol"]), False


def _substreams(x: torch.Tensor, t0: int, t1: int):
    """(S, 256) uint8 rows of tiles [t0, t1) and each row's byte count."""
    part = x[t0 * TILE_BYTES: t1 * TILE_BYTES]
    rows = torch.zeros((t1 - t0) * TILE_BYTES, dtype=torch.uint8,
                       device=x.device)
    rows[: part.numel()] = part
    start = (torch.arange((t1 - t0) * N_SUB, device=x.device) * SUB_BYTES
             + t0 * TILE_BYTES)
    n_k = (x.numel() - start).clamp(0, SUB_BYTES)
    return rows.view(-1, SUB_BYTES), n_k


def _group_encode(rows, n_k, codes_t, lens_t, mcl: int):
    """One group of tiles: its plane words (T,), round bases (T, 64), the
    pulls of every round as (tile, index, P0 word, P1 word), and the words
    its substreams' own streams fill."""
    s = rows.shape[0]
    live = torch.arange(SUB_BYTES, device=rows.device)[None, :] < n_k[:, None]
    sym = rows.long()
    length = torch.where(live, lens_t[sym], 0)
    ends = torch.cumsum(length, 1)
    width = cdiv(SUB_BYTES * mcl, 32) + 4
    own = torch.zeros(s * width, dtype=torch.int64, device=rows.device)
    w, hi, lo = B.place(torch.where(live, codes_t[sym], 0), length,
                        ends - length)
    w = w + torch.arange(s, device=rows.device)[:, None] * width
    B.scatter_words(own, w.reshape(-1), hi.reshape(-1), lo.reshape(-1))
    own = own.view(s, width)
    tiles = s // N_SUB
    avail = torch.zeros(s, dtype=torch.int64, device=rows.device)
    cursor = torch.zeros(s, dtype=torch.int64, device=rows.device)
    pulled = torch.zeros(tiles, dtype=torch.int64, device=rows.device)
    bases = torch.zeros(tiles, ROUNDS, dtype=torch.int64, device=rows.device)
    tile_of = torch.arange(s, device=rows.device) // N_SUB
    pulls = []
    for j in range(ROUNDS):
        bases[:, j] = pulled
        left = n_k - SPR * j
        pull = (left > 0) & (avail < THRESH) & (avail < mcl * left)
        grid = pull.view(tiles, N_SUB).long()
        index = (pulled[:, None] + torch.cumsum(grid, 1) - grid).view(-1)
        k = torch.nonzero(pull).squeeze(1)
        c = cursor[k]
        pulls.append((tile_of[k], index[k], own[k, c], own[k, c + 1]))
        pulled += grid.sum(1)
        cursor += 2 * pull
        avail += 64 * pull
        step = length[:, SPR * j: SPR * (j + 1)].sum(1)
        avail -= step
    return pulled, bases, pulls, int(((ends[:, -1] + 31) >> 5).sum())


def encode(x: torch.Tensor, lengths: np.ndarray):
    """(tile_words (NT,) int64, bases (NT, 64) int64, payload (NW,) int64
    values) of x in the wide format, and the words the substreams' own
    streams fill."""
    codes_t = torch.from_numpy(codebook.canonical_codes(lengths)).to(x.device)
    lens_t = torch.from_numpy(lengths.astype(np.int64)).to(x.device)
    mcl = max(int(lengths.max(initial=0)), 1)
    nt = max(1, cdiv(x.numel(), TILE_BYTES))
    groups = []
    for t0 in range(0, nt, TILES_A_STEP):
        t1 = min(nt, t0 + TILES_A_STEP)
        rows, n_k = _substreams(x, t0, t1)
        groups.append((t0,) + _group_encode(rows, n_k, codes_t, lens_t, mcl))
    tile_words = torch.cat([g[1] for g in groups])
    bases = torch.cat([g[2] for g in groups])
    start = torch.cumsum(2 * tile_words, 0) - 2 * tile_words
    payload = torch.zeros(int(2 * tile_words.sum()), dtype=torch.int64,
                          device=x.device)
    for t0, _, _, pulls, _ in groups:
        for tile, index, w0, w1 in pulls:
            t = tile + t0
            payload[start[t] + index] = w0
            payload[start[t] + tile_words[t] + index] = w1
    return tile_words, bases, payload, sum(g[4] for g in groups)


def header(n: int, config: dict, n_words: int, nt: int) -> bytes:
    return HEADER.pack(MAGIC, VERSION, FLAG_CRC32, n, TILE_BYTES,
                       config["max_code_len"], 32 * n_words, nt)


def payload_offset(nt: int) -> int:
    return HEADER.size + 256 + 4 * nt + 2 * ROUNDS * nt


def dumps(n: int, config: dict, lengths, tile_words, bases, payload):
    """The container's bytes, for the control and the tests."""
    body = payload.cpu().numpy().astype("<u4").tobytes()
    return (header(n, config, payload.numel(), tile_words.numel())
            + lengths.astype(np.uint8).tobytes()
            + tile_words.cpu().numpy().astype("<u4").tobytes()
            + bases.cpu().numpy().astype("<u2").tobytes() + body
            + struct.pack("<I", zlib.crc32(body)))


def loads(blob: bytes, device):
    """(n, lengths, tile_words, payload) of a container, for the control."""
    _, _, _, n, _, _, total, nt = HEADER.unpack_from(blob, 0)
    lengths = np.frombuffer(blob, np.uint8, 256, HEADER.size).astype(np.int32)
    tile_words = np.frombuffer(blob, "<u4", nt, HEADER.size + 256)
    payload = np.frombuffer(blob, "<u4", total // 32, payload_offset(nt))
    return (n, lengths,
            torch.from_numpy(tile_words.astype(np.int64)).to(device),
            torch.from_numpy(payload.astype(np.int64)).to(device))


def decode(n: int, lengths: np.ndarray, tile_words: torch.Tensor,
           payload: torch.Tensor) -> torch.Tensor:
    """The n bytes of a wide stream: the reader of the specification, the
    pulled words kept in each substream's own word list."""
    device = payload.device
    mcl = max(int(lengths.max(initial=0)), 1)
    syms, lens = (torch.from_numpy(t).to(device)
                  for t in codebook.decode_table(lengths, mcl))
    nt = tile_words.numel()
    start = torch.cumsum(2 * tile_words, 0) - 2 * tile_words
    out = []
    for t0 in range(0, nt, TILES_A_STEP):
        t1 = min(nt, t0 + TILES_A_STEP)
        tiles, s = t1 - t0, (t1 - t0) * N_SUB
        first = torch.arange(s, device=device) * SUB_BYTES + t0 * TILE_BYTES
        n_k = (n - first).clamp(0, SUB_BYTES)
        width = cdiv(SUB_BYTES * mcl, 32) + 4
        own = torch.zeros(s, width, dtype=torch.int64, device=device)
        avail = torch.zeros(s, dtype=torch.int64, device=device)
        cursor = torch.zeros(s, dtype=torch.int64, device=device)
        pos = torch.zeros(s, dtype=torch.int64, device=device)
        pulled = torch.zeros(tiles, dtype=torch.int64, device=device)
        tile_of = torch.arange(s, device=device) // N_SUB + t0
        rows = torch.zeros(SUB_BYTES, s, dtype=torch.uint8, device=device)
        flat = torch.arange(s, device=device) * width
        for j in range(ROUNDS):
            left = n_k - SPR * j
            pull = (left > 0) & (avail < THRESH) & (avail < mcl * left)
            grid = pull.view(tiles, N_SUB).long()
            index = (pulled[:, None] + torch.cumsum(grid, 1) - grid).view(-1)
            k = torch.nonzero(pull).squeeze(1)
            t = tile_of[k]
            at = start[t] + index[k]
            own.view(-1)[flat[k] + cursor[k]] = payload[at]
            own.view(-1)[flat[k] + cursor[k] + 1] = payload[at + tile_words[t]]
            pulled += grid.sum(1)
            cursor += 2 * pull
            avail += 64 * pull
            for u in range(SPR):
                live = SPR * j + u < n_k
                # the code is the window's prefix: bits past it, even of
                # the next substream's words, do not change it
                idx = B.window(own.view(-1), 32 * flat + pos) >> (32 - mcl)
                rows[SPR * j + u] = torch.where(live, syms[idx], 0).to(
                    torch.uint8)
                step = torch.where(live, lens[idx], 0)
                pos += step
                avail -= step
        out.append(rows.T.reshape(-1))
    return torch.cat(out)[:n]


def expect(x: torch.Tensor, config: dict, shards: int = 1):
    """What the program's container for x must hold: its sections as
    (name, offset, byte order, int64 values), its size, and the work the
    kernels' byte counts read."""
    lengths, _ = choose_lengths(x, config)
    tile_words, bases, payload, sub_words = encode(x, lengths)
    n, nt = x.numel(), tile_words.numel()
    dev = x.device
    sections = [
        ("header", 0, "u8", torch.tensor(
            list(header(n, config, payload.numel(), nt)), device=dev)),
        ("lengths", HEADER.size, "u8", torch.from_numpy(
            lengths.astype(np.int64)).to(dev)),
        ("tile_words", HEADER.size + 256, "<u4", tile_words),
        ("bases", HEADER.size + 256 + 4 * nt, "<u2", bases.reshape(-1)),
        ("payload", payload_offset(nt), "<u4", payload)]
    work = {"format": "wide", "n": n, "nt": nt, "ns": nt * N_SUB,
            "sub_words": sub_words, "payload_words": payload.numel(),
            "mcl": max(int(lengths.max(initial=0)), 1), "shards": shards}
    return sections, payload_offset(nt) + 4 * payload.numel() + 4, work
