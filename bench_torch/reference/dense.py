"""Plain reference of the dense codec (container version 1), in PyTorch.

The format: bytes in blocks of `block_bytes`; every byte's canonical code
follows the last one's, MSB-first, with no gap between blocks, so the
stream is the reference encoder's (PAVLE's cpuencode.cpp) bit for bit.
The container holds a header, the 256 code lengths, each block's bit count
and the stream words big-endian, then the CRC-32 of those payload bytes.

The codebook is built from the input's byte counts (codebook.py), or from
the counts of every `sample_every`-th block where the configuration's
`reference_policy` (the program's fixed sampling policy, stated for the
reference) samples and the input is at least `sample_min_bytes`, unless
some byte of the input has no code in that book; then from all counts.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from . import bits as B
from . import codebook

HEADER = struct.Struct("<4sIIQIIQI")   # magic, version, flags, n, bb, cap,
                                       # total bits, blocks
MAGIC, VERSION, FLAG_CRC32 = b"HTZ1", 1, 1
CHUNK = 32 << 20                       # bytes a step of the reference


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def byte_counts(x: torch.Tensor) -> np.ndarray:
    return torch.bincount(x, minlength=256).cpu().numpy()


def sample(x: torch.Tensor, block_bytes: int, every: int) -> torch.Tensor:
    """Blocks 0, every, 2 * every, ... of x, in order."""
    full = x.numel() // block_bytes
    rows = x[: full * block_bytes].view(full, block_bytes)[::every].reshape(-1)
    if x.numel() > full * block_bytes and full % every == 0:
        rows = torch.cat([rows, x[full * block_bytes:]])
    return rows


def sample_every(config: dict) -> int:
    """Every how many blocks the sample takes one, or 0 where the
    configuration's path never samples."""
    return config.get("reference_policy", {}).get("sample_every", 0)


def choose_lengths(x: torch.Tensor, config: dict):
    """The code lengths of the configuration's codebook for x, and whether
    they come from the sample."""
    cap, tol = config["max_code_len"], config["narrow_tol"]
    full = byte_counts(x)
    every = sample_every(config)
    if (every > 1 and x.numel()
            >= config["reference_policy"]["sample_min_bytes"]):
        lengths = codebook.code_lengths(
            byte_counts(sample(x, config["block_bytes"], every)), cap, tol)
        if not ((full > 0) & (lengths == 0)).any():
            return lengths, True
    return codebook.code_lengths(full, cap, tol), False


def _code_tables(lengths: np.ndarray, device):
    return (torch.from_numpy(codebook.canonical_codes(lengths)).to(device),
            torch.from_numpy(lengths.astype(np.int64)).to(device))


def encode(x: torch.Tensor, lengths: np.ndarray, block_bytes: int):
    """(block_bits (NB,) int64, words (NW,) int64 values) of x's stream."""
    codes_t, lens_t = _code_tables(lengths, x.device)
    n = x.numel()
    nb = max(1, cdiv(n, block_bytes))
    block_bits = torch.zeros(nb, dtype=torch.int64, device=x.device)
    step = CHUNK // block_bytes * block_bytes
    for lo in range(0, n, step):
        length = lens_t[x[lo: lo + step].long()]
        pad = (-length.numel()) % block_bytes
        per_block = torch.nn.functional.pad(length, (0, pad)).view(
            -1, block_bytes).sum(1)
        block_bits[lo // block_bytes: lo // block_bytes + per_block.numel()] \
            = per_block
    total = int(block_bits.sum())
    words = torch.zeros(cdiv(total, 32) + 2, dtype=torch.int64,
                        device=x.device)
    base = 0
    for lo in range(0, n, step):
        sym = x[lo: lo + step].long()
        length = lens_t[sym]
        ends = torch.cumsum(length, 0)
        w, hi, lo_bits = B.place(codes_t[sym], length, base + ends - length)
        B.scatter_words(words, w, hi, lo_bits)
        base += int(ends[-1])
    return block_bits, words[: cdiv(total, 32)]


def header(n: int, config: dict, total_bits: int, nb: int) -> bytes:
    return HEADER.pack(MAGIC, VERSION, FLAG_CRC32, n, config["block_bytes"],
                       config["max_code_len"], total_bits, nb)


def payload_offset(nb: int) -> int:
    return HEADER.size + 256 + 4 * nb


def dumps(n: int, config: dict, lengths: np.ndarray, block_bits, words):
    """The container's bytes, for the control and the tests."""
    total = int(block_bits.sum())
    payload = B.byteswap32(words).cpu().numpy().astype("<u4").tobytes()
    return (header(n, config, total, block_bits.numel())
            + lengths.astype(np.uint8).tobytes()
            + block_bits.cpu().numpy().astype("<u4").tobytes() + payload
            + struct.pack("<I", zlib.crc32(payload)))


def loads(blob: bytes, device):
    """(n, lengths, block_bits, words) of a container, for the control."""
    _, _, _, n, _, _, total, nb = HEADER.unpack_from(blob, 0)
    lengths = np.frombuffer(blob, np.uint8, 256, HEADER.size).astype(np.int32)
    block_bits = torch.from_numpy(np.frombuffer(
        blob, "<u4", nb, HEADER.size + 256).astype(np.int64)).to(device)
    words = torch.from_numpy(np.frombuffer(
        blob, ">u4", cdiv(total, 32), payload_offset(nb)).astype(np.int64))
    return n, lengths, block_bits, words.to(device)


def decode(n: int, lengths: np.ndarray, block_bits: torch.Tensor,
           words: torch.Tensor, block_bytes: int) -> torch.Tensor:
    """The n bytes of a stream, every block read from its own first bit,
    one byte of every block a step."""
    device = words.device
    tb = max(int(lengths.max(initial=0)), 1)
    syms, lens = (torch.from_numpy(t).to(device)
                  for t in codebook.decode_table(lengths, tb))
    nb = block_bits.numel()
    pos = torch.cumsum(block_bits, 0) - block_bits
    valid = (n - torch.arange(nb, device=device) * block_bytes).clamp(
        0, block_bytes)
    out = torch.zeros(block_bytes, nb, dtype=torch.uint8, device=device)
    for i in range(block_bytes):
        idx = B.window(words, pos) >> (32 - tb)
        live = i < valid
        out[i] = torch.where(live, syms[idx], 0).to(torch.uint8)
        pos = pos + torch.where(live, lens[idx], 0)
    return out.T.reshape(-1)[:n]


def expect(x: torch.Tensor, config: dict, shards: int = 1):
    """What the program's container for x must hold: its sections as
    (name, offset, byte order, int64 values), its size, and the work the
    kernels' byte counts read."""
    bb = config["block_bytes"]
    lengths, sampled = choose_lengths(x, config)
    block_bits, words = encode(x, lengths, bb)
    n, nb, total = x.numel(), block_bits.numel(), int(block_bits.sum())
    dev = x.device
    sections = [
        ("header", 0, "u8", torch.tensor(list(header(n, config, total, nb)),
                                         device=dev)),
        ("lengths", HEADER.size, "u8", torch.from_numpy(
            lengths.astype(np.int64)).to(dev)),
        ("table", HEADER.size + 256, "<u4", block_bits),
        ("payload", payload_offset(nb), ">u4", words)]
    work = {"format": "dense", "n": n, "nb": nb, "block_bytes": bb,
            "block_words": ((block_bits + 31) >> 5).cpu().numpy(),
            "stream_words": words.numel(),
            "table_bits": max(int(lengths.max(initial=0)), 1),
            "sample_bytes": (sample(x, bb, sample_every(config)).numel()
                             if sample_every(config) > 1 else 0),
            "book_from_sample": sampled, "shards": shards}
    return sections, payload_offset(nb) + 4 * words.numel() + 4, work
