"""The plain version of the v1 container's payload swap and CRC-32, in one
pass: ops/cuda/crc32.swap_crc32 launches the CUDA kernel (csrc/crc32.cu)
for CUDA tensors and runs swap_crc32_plain for CPU ones.  It byte-swaps
32-bit words between the stream's host order and the payload's big-endian
order, in either direction, and writes the CRC-32 of the payload bytes
(zlib's) beside.  The JAX package has no such stage on the device: it
swaps with numpy and takes zlib.crc32 on the host.  copy_crc32_plain is
the same pass without the swap, its CRC optionally going on from another
(ops/cuda/crc32.copy_crc32: the raw plane of a container version 4).

The plain version takes the CRC as the kernel does, by pieces combined:
CRCs of equal rows of the zero-padded payload, combined pairwise by
multiplying by x^(8 len) mod P (zlib's crc32_combine).
"""

from __future__ import annotations

import torch

from . import Counter

# calls on CUDA tensors; the main path makes none (it launches the kernel)
cuda_calls = Counter()

POLY = 0xEDB88320                 # zlib's polynomial, bit-reflected
X0 = 0x80000000                   # x^0, bit-reflected
ROW_BYTES = 64                    # bytes a row of the plain CRC


def word_bytes(words: torch.Tensor) -> torch.Tensor:
    """The bytes of int32 words in memory order, as a 1-D uint8 view."""
    if not words.numel():                 # an empty tensor may have stride 0
        return words.new_empty(0, dtype=torch.uint8)
    return words.view(torch.uint8)


def byteswap(words: torch.Tensor) -> torch.Tensor:
    """Each int32 word with its four bytes reversed."""
    return (word_bytes(words).view(-1, 4).flip(1).reshape(-1)
            .view(torch.int32))


def swap_crc32_plain(src: torch.Tensor, dst: torch.Tensor,
                     crc: torch.Tensor, to_payload: bool) -> torch.Tensor:
    """The plain version: a byte swap in PyTorch and crc32_plain."""
    if src.is_cuda:
        cuda_calls.n += 1
    swapped = byteswap(src)
    dst.copy_(swapped)
    payload = swapped if to_payload else src
    value = crc32_plain(word_bytes(payload))
    crc.copy_((value - (value >> 31 << 32)).to(torch.int32).view(1))
    return crc


def copy_crc32_plain(src: torch.Tensor, dst: torch.Tensor | None,
                     crc: torch.Tensor,
                     start: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of copy_crc32: src's words copied to dst (where
    given), and the CRC-32 of their bytes, going on from the one in
    `start` where given, written to crc."""
    if src.is_cuda:
        cuda_calls.n += 1
    if dst is not None:
        dst.copy_(src)
    data = word_bytes(src)
    value = crc32_plain(data)
    if start is not None:
        value = crc32_combine(start.to(torch.int64)[0] & 0xFFFFFFFF, value,
                              data.numel())
    crc.copy_((value - (value >> 31 << 32)).to(torch.int32).view(1))
    return crc


def multmodp(a: int, b):
    """a * b mod P, bit-reflected (zlib's multmodp), for a Python int a and
    b a Python int or an int64 tensor of 32-bit values."""
    p = b * 0
    for i in range(32):
        if (a >> (31 - i)) & 1:
            p = p ^ b
        b = (b >> 1) ^ (POLY * (b & 1))
    return p


# x^(2^k) mod P for k = 0..31 (zlib's x2n_table): x's order divides
# 2^32 - 1, so x^(2^32) = x and the table repeats from k = 32 on
X2N = [X0 >> 1]
for _ in range(31):
    X2N.append(multmodp(X2N[-1], X2N[-1]))


def x8nmodp(n: int) -> int:
    """x^(8 n) mod P: the shift of a CRC past n bytes (zlib's x2nmodp(n,
    3))."""
    p, k = X0, 3
    while n:
        if n & 1:
            p = multmodp(X2N[k & 31], p)
        n, k = n >> 1, k + 1
    return p


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """zlib.crc32 of A + B from crc1 = zlib.crc32(A), crc2 = zlib.crc32(B)
    and len2 = len(B) (zlib's crc32_combine).  crc1 may be any start
    value: crc32_combine(v, zlib.crc32(B), len(B)) == zlib.crc32(B, v)."""
    return multmodp(x8nmodp(len2), crc1) ^ crc2


def _table(device) -> torch.Tensor:
    t = torch.arange(256, dtype=torch.int64, device=device)
    for _ in range(8):
        t = (t >> 1) ^ (POLY * (t & 1))
    return t


def crc32_plain(data: torch.Tensor) -> torch.Tensor:
    """zlib.crc32 of a 1-D uint8 tensor, as a 0-d int64 tensor on its
    device: the raw CRC (initial value 0, no final inversion) of each
    ROW_BYTES row of the data padded in front with zero bytes (which leave
    a raw CRC unchanged), the rows combined pairwise, then zlib's affine
    term ~0 x^(8 n) + ~0."""
    n = data.numel()
    rows = torch.cat([data.new_zeros((-n) % ROW_BYTES), data]).view(
        -1, ROW_BYTES)
    table = _table(data.device)
    crc = torch.zeros(rows.shape[0], dtype=torch.int64, device=data.device)
    for j in range(ROW_BYTES):
        crc = table[(crc ^ rows[:, j].to(torch.int64)) & 255] ^ (crc >> 8)
    length = ROW_BYTES
    while crc.numel() > 1:
        if crc.numel() % 2:                  # a zero row in front
            crc = torch.cat([crc.new_zeros(1), crc])
        pairs = crc.view(-1, 2)
        crc = multmodp(x8nmodp(length), pairs[:, 0]) ^ pairs[:, 1]
        length *= 2
    raw = crc.sum()                          # 0 rows: 0
    return raw ^ (multmodp(x8nmodp(n), 0xFFFFFFFF) ^ 0xFFFFFFFF)
