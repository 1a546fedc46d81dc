"""Plain reference of DFloat11's planes of bf16 words (arXiv:2504.11651)
in a container version 4, in PyTorch.

Each bf16 word w of the input (its two bytes little-endian) is split into
its exponent byte e = (w >> 7) & 0xFF and its sign-mantissa byte
s = ((w >> 8) & 0x80) | (w & 0x7F).  The exponent plane is coded as the
dense reference codes bytes (dense.py: the same codebook rule and sampling
policy, stream and block bit counts); the sign-mantissa plane is kept
raw.  The container: v1's header with version 4 and n the elements, the
256 code lengths, the block bit counts, then one payload, the stream words
big-endian followed by the n plane bytes, then the CRC-32 of that payload.
Imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dense

VERSION = 4
CHUNK = 32 << 20                       # words a step of the split


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(exponent, sign_mantissa): the (n,) uint8 planes of the 2n bytes
    x, n little-endian bf16 words."""
    if x.numel() % 2:
        raise ValueError("bf16 words take an even number of bytes")
    n = x.numel() // 2
    exponent = torch.empty(n, dtype=torch.uint8, device=x.device)
    sign_mantissa = torch.empty(n, dtype=torch.uint8, device=x.device)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        pair = x[2 * lo: 2 * hi].view(-1, 2).to(torch.int32)
        w = pair[:, 0] | (pair[:, 1] << 8)
        exponent[lo:hi] = ((w >> 7) & 0xFF).to(torch.uint8)
        sign_mantissa[lo:hi] = (((w >> 8) & 0x80) | (w & 0x7F)).to(
            torch.uint8)
    return exponent, sign_mantissa


def header(n: int, config: dict, total_bits: int, nb: int) -> bytes:
    return dense.HEADER.pack(dense.MAGIC, VERSION, dense.FLAG_CRC32, n,
                             config["block_bytes"], config["max_code_len"],
                             total_bits, nb)


def big_endian_bytes(words: torch.Tensor) -> torch.Tensor:
    """The bytes of int64 values < 2**32 as 32-bit big-endian words."""
    return torch.stack([(words >> s) & 0xFF for s in (24, 16, 8, 0)],
                       1).reshape(-1).to(torch.uint8)


def expect(x: torch.Tensor, config: dict, shards: int = 1):
    """What the program's container for the bf16 words x must hold: its
    sections as (name, offset, byte order, values), the payload's (stream
    bytes, then the plane) last, so that the check's CRC covers both; its
    size; and the work the kernels' byte counts read."""
    bb = config["block_bytes"]
    exponent, sign_mantissa = split(x)
    lengths, sampled = dense.choose_lengths(exponent, config)
    block_bits, words = dense.encode(exponent, lengths, bb)
    n, nb, total = exponent.numel(), block_bits.numel(), int(block_bits.sum())
    payload = torch.cat([big_endian_bytes(words), sign_mantissa])
    dev = x.device
    sections = [
        ("header", 0, "u8", torch.tensor(list(header(n, config, total, nb)),
                                         device=dev)),
        ("lengths", dense.HEADER.size, "u8", torch.from_numpy(
            lengths.astype(np.int64)).to(dev)),
        ("table", dense.HEADER.size + 256, "<u4", block_bits),
        ("payload", dense.payload_offset(nb), "u8", payload)]
    every = dense.sample_every(config)
    work = {"format": "df11", "elements": n, "coded_bytes": n, "nb": nb,
            "block_bytes": bb, "stream_words": words.numel(),
            "table_bits": max(int(lengths.max(initial=0)), 1),
            "sample_bytes": (dense.sample(exponent, bb, every).numel()
                             if every > 1 else 0),
            "book_from_sample": sampled, "shards": shards}
    return sections, dense.payload_offset(nb) + payload.numel() + 4, work
