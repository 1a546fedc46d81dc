"""Wrapper of the CUDA offset scan (csrc/scan.cu), in place of the JAX
package's offset scan (huffman_tpu/ops/scan.py exclusive_bit_offsets, a
split-form pair of jnp.cumsum that XLA fuses; no Pallas kernel).  One
kernel serves the dense block offsets and the wide tiles' payload
offsets."""

from __future__ import annotations

import torch

from .. import Counter
from .. import scan as plain
from . import _build

SOURCE = "huffman_tpu_torch/csrc/scan.cu"
REPLACES = "huffman_tpu/ops/scan.py:44"
launches = Counter()

TILE = 4096                     # items a CTA scans (SCAN_TILE in scan.cu)
VALUE_CAP = (1 << 62) - 1       # the status word's value field: a total
                                # that reaches it is refused
_COUNT_MAX = (1 << 31) - 1      # the largest int32 count


def _check(x: torch.Tensor, start_bit: int) -> None:
    if (x.dtype.is_floating_point or x.dtype.is_complex
            or x.dtype == torch.bool):
        raise ValueError(f"offset scan: want integer counts, got {x.dtype}")
    if x.dim() != 1:
        raise ValueError(f"offset scan: want a 1-D tensor, got shape "
                         f"{tuple(x.shape)}")
    if not 0 <= start_bit <= 31:
        raise ValueError(f"offset scan: start_bit {start_bit} outside 0..31")


def bit_offsets(block_bits: torch.Tensor,
                start_bit: int = 0) -> plain.BitOffsets:
    """ops.scan.exclusive_bit_offsets_plain on the card: block_bits a
    contiguous 1-D int32 tensor of non-negative counts."""
    _check(block_bits, start_bit)
    if block_bits.device.type == "cpu":
        return plain.exclusive_bit_offsets_plain(block_bits, start_bit)
    out, shift, totals = _launch(block_bits, start_bit, 1, True)
    return plain.BitOffsets(word_base=out, bit_shift=shift,
                            total_bits=totals[0], total_words=totals[1])


def payload_offsets(tile_words: torch.Tensor):
    """ops.scan.payload_offsets_plain on the card: tile_words a contiguous
    1-D int32 tensor of non-negative counts.  Returns (each tile's first
    payload word, the payload length), int64 on the device."""
    _check(tile_words, 0)
    if tile_words.device.type == "cpu":
        return plain.payload_offsets_plain(tile_words)
    out, _, totals = _launch(tile_words, 0, 2, False)
    return out, totals[0]


def _launch(x: torch.Tensor, start_bit: int, scale: int, split: bool):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"offset scan: unsupported device {dev}")
    n = x.numel()
    _build.require(x, "counts", torch.int32, (n,), dev)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    shift = torch.empty(n, dtype=torch.int32, device=dev) if split else None
    if n == 0:
        return out, shift, torch.tensor([start_bit, (start_bit + 31) >> 5],
                                        dtype=torch.int64, device=dev)
    totals = torch.empty(2, dtype=torch.int64, device=dev)
    # the tiles' status words and the tile counter, cleared by the entry
    work = torch.empty(-(-n // TILE) + 1, dtype=torch.int64, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):          # the launch uses the current device
        err = lib.huff_bit_offsets(
            x.data_ptr(), n, start_bit, scale, out.data_ptr(),
            shift.data_ptr() if split else None, totals.data_ptr(),
            work.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "offset scan")
    launches.n += 1
    # only counts this many can reach the cap: then one host sync
    if (start_bit + scale * n * _COUNT_MAX >= VALUE_CAP
            and int(totals[0]) < 0):
        raise OverflowError(f"offset scan: the total of {n} counts reaches "
                            f"2^62 - 1, past the kernel's status word")
    return out, shift, totals
