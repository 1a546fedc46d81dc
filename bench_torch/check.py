"""The comparison that decides `correct` in the roundtrip loop.

After the window, the input is drawn again on the card from the seed,
and the configuration's plain reference (reference/<name>.py) works out
the codebook, the stream or payload, every table and the header that the
container must hold.  Two numbers are compared, each with the limit 0 (an
exact comparison; Loop.LIMITS of loops/roundtrip.py):

  encoded_mismatches: over every container the window produced, the
    header bytes, code lengths, table entries (block bit counts, or plane
    lengths and pull bases) and payload words that differ from the
    reference's, the entries missing or extra, and a CRC-32 that does not
    match the payload;
  decoded_mismatches: over every decoded output, the bytes that differ
    from the input, and those missing or extra.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
import warnings
import zlib

import numpy as np
import torch

WIDTH = {"u8": 1, "<u2": 2, "<u4": 4, ">u4": 4}
STEP = 1 << 24                    # entries compared at a time

_libc = ctypes.CDLL(ctypes.util.find_library("c"))
_libc.memcmp.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
_libc.memcmp.restype = ctypes.c_int


def same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.nbytes == b.nbytes and a.flags.c_contiguous
            and b.flags.c_contiguous
            and _libc.memcmp(a.ctypes.data, b.ctypes.data, a.nbytes) == 0)


class Outputs:
    """Every roundtrip's container and decoded output, as the window made
    them.  A container equal to the first one, byte for byte, is held as
    that one, and a decoded output equal to the host input as the input;
    any other is kept whole.  So a run holds a few GB of host memory
    however long its window, and the comparison after the window still
    reaches every roundtrip."""

    def __init__(self, arr: np.ndarray):
        self.arr, self.blobs, self.which, self.outputs = arr, [], [], []

    def add(self, blob: bytes, out: np.ndarray) -> None:
        if not self.blobs or blob != self.blobs[0]:
            self.blobs.append(blob)
            self.which.append(len(self.blobs) - 1)
        else:
            self.which.append(0)
        self.outputs.append(None if same_bytes(out, self.arr) else out)


def _device_bytes(buf, device) -> torch.Tensor:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # read-only buffers
        return torch.from_numpy(np.frombuffer(buf, np.uint8)).to(device)


def _values(raw: torch.Tensor, order: str) -> torch.Tensor:
    """(m, width) bytes as int64 values in the byte order."""
    raw = raw.long()
    cols = range(raw.shape[1])
    if order.startswith(">"):
        cols = reversed(list(cols))
    return sum(raw[:, c] << (8 * i) for i, c in enumerate(cols))


def container_mismatches(blob: bytes, sections, size: int) -> dict:
    """Mismatches of one container against the reference's sections, by
    section, with its CRC and its size."""
    device = sections[0][3].device
    data = _device_bytes(blob, device)
    out = {}
    for name, offset, order, want in sections:
        width, count = WIDTH[order], want.numel()
        have = max(0, min(count, (len(blob) - offset) // width))
        out[name] = count - have
        for lo in range(0, have, STEP):
            hi = min(have, lo + STEP)
            got = _values(data[offset + lo * width: offset + hi * width]
                          .view(hi - lo, width), order)
            out[name] += int((got != want[lo:hi]).sum())
    name, offset, order, want = sections[-1]          # the payload
    end = offset + WIDTH[order] * want.numel()
    stored = blob[end: end + 4]
    out["crc"] = int(len(stored) < 4 or struct.unpack("<I", stored)[0]
                     != zlib.crc32(memoryview(blob)[offset: end]))
    out["size"] = abs(len(blob) - size)
    return out


def _byte_mismatches(got: np.ndarray, x: torch.Tensor) -> int:
    m = min(got.size, x.numel())
    return (int((_device_bytes(got[:m], x.device) != x[:m]).sum())
            + abs(got.size - x.numel()))


def compare(x: torch.Tensor, reference, config: dict, shards: int,
            kept: Outputs):
    """(numbers, failed, details, work): the compared numbers over every
    roundtrip's container and decoded output, the roundtrips with any
    mismatch, the first container's mismatches by section, and the
    reference's counts of the work the kernels do."""
    sections, size, work = reference.expect(x, config, shards)
    per_blob = [container_mismatches(b, sections, size) for b in kept.blobs]
    encoded = [sum(per_blob[i].values()) for i in kept.which]
    from_input = _byte_mismatches(kept.arr, x)      # the host input itself
    decoded = [from_input if out is None else _byte_mismatches(out, x)
               for out in kept.outputs]
    numbers = {"encoded_mismatches": sum(encoded),
               "decoded_mismatches": sum(decoded)}
    failed = sum(bool(e or d) for e, d in zip(encoded, decoded))
    details = {"roundtrips": len(kept.which),
               "distinct_containers": len(kept.blobs),
               "outputs_unlike_input": sum(o is not None
                                           for o in kept.outputs),
               "first_container": per_blob[0] if per_blob else None,
               "book_from_sample": work.get("book_from_sample")}
    return numbers, failed, details, work
