"""The .htz containers, version 1 (dense) and 3 (wide), byte-identical to
huffman_tpu's, and version 4 (bf16 planes, the port's own).

Layout (integers little-endian), as in huffman_tpu/container.py:

  offset  size  field
  0       4     magic  b"HTZ1"
  4       4     version (u32) = 1
  8       4     flags (u32; bit 0 = payload CRC-32 appended)
  12      8     original length in bytes (u64)
  20      4     block_bytes (u32)
  24      4     max_code_len (u32)
  28      8     total_bits (u64)
  36      4     num_blocks (u32)
  40      256   code lengths, one byte per symbol
  296     4*NB  per-block bit counts (u32 each)
  ...           payload: ceil(total_bits/32) words, each stored big-endian
                (the payload bytes are the MSB-first bitstream)
  ...     4     CRC-32 of the payload bytes (when flags bit 0 is set)

dumps_device and loads_device write and read the same v1 bytes in one
uint8 tensor in a device's memory, for a ResidentEncoded: the head (header
and code lengths) crosses as 296 bytes, the block bit counts are copied on
the device, and the payload's byte swap and its CRC-32 run in one kernel
(ops/cuda/crc32.py).  The payload offset, 296 + 4 * NB, is a multiple of
4, so the payload is written and read as words in place.

Version 4 (DFloat11's planes of a bf16 tensor, api.PlanesEncoded), in
card memory only (dumps_device, loads_device): v1's header with version 4
and n the elements, the exponent plane's 256 code lengths and block bit
counts, then a payload of its stream words, big-endian, followed by the n
raw sign-mantissa bytes, then the CRC-32 of that whole payload.  The
plane's part of the CRC goes on from the stream's on the card (copy_crc32,
a pass without the swap) over its whole words; where n is not a multiple
of 4 its last 1-3 bytes are added on the host.  loads_device's plane is a
view of the buffer it reads.

Version 3 (the wide format, golden/wide_codec.py), as in the JAX package:
the same header with block_bytes := the tile size (TILE_BYTES), total_bits
:= payload words * 32 and num_blocks := the tile count; the per-block table
holds each tile's plane length in words (u32), followed by each tile's
ROUNDS per-round pull bases (u16: plane words per tile are < 2**16), then
the payload, tile after tile, each P0 then P1, words little-endian (they
are the reader's machine words, not a bitstream), then the optional CRC.

On the host each payload byte is swapped (v1) or copied (v3) at most once
and checksummed once before dumps' one join into the returned bytes:
dumps swaps into a buffer that its thread keeps from call to call,
dumps_wide and loads_wide (of a bytes object) read the words in place,
and loads takes the CRC over a memoryview.  From PINNED_MIN_BYTES (16
MiB) of payload on, the swap, copy and CRC each run in WORKERS equal,
word-aligned pieces on a pool of threads (numpy's casts and zlib.crc32
release the GIL), the pieces' CRCs joined by crc32_combine; a smaller
payload is worked in one piece on the calling thread.  The workers open
no span: the calling thread's container.words and container.crc cover all
of their pieces.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .api import Encoded, PlanesEncoded, ResidentEncoded
from .codebook import Codebook
from .config import CodecConfig, cdiv
from .golden.wide_codec import MAXLEN, ROUNDS, TILE_BYTES
from .ops.crc32 import crc32_combine
from .ops.cuda.crc32 import copy_crc32, swap_crc32
from .transfer import PINNED_MIN_BYTES, to_device, to_host
from .utils import timing
from .utils.timing import span
from .wide import WideEncoded

MAGIC = b"HTZ1"
VERSION = 1
WIDE_VERSION = 3
PLANES_VERSION = 4
_HEADER = struct.Struct("<4sIIQIIQI")  # magic, ver, flags, n, bb, mcl, bits, nb
FLAG_CRC32 = 1
WORKERS = min(os.cpu_count() or 1, 8)     # threads of the pieces' pool

_pool: tuple[int, ThreadPoolExecutor] | None = None   # (pid, pool)
_pool_lock = threading.Lock()
_scratch = threading.local()              # .words: dumps' payload buffer


def overhead_bytes(num_blocks: int) -> int:
    """Container overhead for a given block count (header + tables)."""
    return _HEADER.size + 256 + 4 * num_blocks


def _workers() -> ThreadPoolExecutor:
    """The process's pool of WORKERS threads, made at first use, and again
    in a forked child, whose copy of the pool has no threads."""
    global _pool
    with _pool_lock:
        if _pool is None or _pool[0] != os.getpid():
            _pool = (os.getpid(), ThreadPoolExecutor(
                WORKERS, thread_name_prefix="htz-container"))
        return _pool[1]


def _piece_count(nbytes: int) -> int:
    """How many pieces a payload of nbytes is worked in: WORKERS from
    PINNED_MIN_BYTES on, else 1.  The CPU tests patch it."""
    return WORKERS if nbytes >= PINNED_MIN_BYTES else 1


def _bounds(nbytes: int) -> list[int]:
    """Byte offsets of the equal, word-aligned pieces of a payload of
    nbytes, first 0 and last nbytes."""
    k, words = _piece_count(nbytes), nbytes // 4
    return [4 * (words * i // k) for i in range(k)] + [nbytes]


def _run(fn, bounds: list[int]) -> list:
    """fn(a, b) for each piece [a, b) of bounds, on the workers where there
    are several pieces, else on the calling thread; the results in order.
    The bytes are counted in timing.container_bytes, on the calling
    thread."""
    pieces = len(bounds) > 2
    timing.container_bytes["pieces" if pieces else "whole"].n += \
        bounds[-1] - bounds[0]
    if not pieces:
        return [fn(bounds[0], bounds[1])]
    return list(_workers().map(fn, bounds[:-1], bounds[1:]))


def _crc32(data, bounds: list[int]) -> int:
    """zlib.crc32 of the bytes-like `data`, taken piece by piece over
    bounds (byte offsets into it) and joined."""
    view = memoryview(data).cast("B")
    crcs = _run(lambda a, b: zlib.crc32(view[a:b]), bounds)
    value = 0
    for crc, a, b in zip(crcs, bounds, bounds[1:]):
        value = crc32_combine(value, crc, b - a)
    return value


def _copy_words(dst: np.ndarray, src: np.ndarray) -> None:
    """dst[:] = src for 1-D arrays of as many 32-bit words, the byte order
    converted where the two differ, in the pieces of _bounds."""
    def piece(a: int, b: int) -> None:
        np.copyto(dst[a // 4: b // 4], src[a // 4: b // 4])
    _run(piece, _bounds(dst.nbytes))


def _payload_buffer(n_words: int) -> np.ndarray:
    """n_words big-endian words over a buffer that the calling thread keeps
    from call to call, so that its pages are faulted in once, not at
    every dumps.  It is sized to a power of two; pages never written
    cost no memory."""
    buf = getattr(_scratch, "words", None)
    if buf is None or buf.size < n_words:
        buf = _scratch.words = np.empty(1 << (n_words - 1).bit_length()
                                        if n_words else 0, np.uint32)
    return buf[:n_words].view(">u4")


def _crc(payload: np.ndarray, checksum: bool) -> bytes:
    """The CRC field of the payload bytes (uint8), b"" without a
    checksum."""
    with span("container.crc"):
        return (struct.pack("<I", _crc32(payload, _bounds(payload.nbytes)))
                if checksum else b"")


def _head(enc, version: int, checksum: bool, block_bytes: int,
          total_bits: int, num_blocks: int) -> bytes:
    """The header and the 256 code lengths of enc's container (any
    version: Encoded, ResidentEncoded or WideEncoded)."""
    return _HEADER.pack(MAGIC, version, FLAG_CRC32 if checksum else 0,
                        enc.n_bytes, block_bytes, enc.config.max_code_len,
                        total_bits, num_blocks) + \
        np.asarray(enc.codebook.lengths, dtype=np.uint8).tobytes()


def _dense_head(enc, checksum: bool, version: int = VERSION) -> bytes:
    """_head of a v1 container, Encoded's or ResidentEncoded's, or of a v4
    container, whose exponent plane's ResidentEncoded enc is."""
    return _head(enc, version, checksum, enc.config.block_bytes,
                 enc.total_bits, len(enc.block_bits))


def dumps(enc: Encoded, checksum: bool = True) -> bytes:
    """Serialize an Encoded stream to container bytes, under a root span
    "container.dumps" (children container.words, the payload's
    big-endian swap into the thread's buffer; container.crc;
    container.join, the one copy into the bytes returned)."""
    with span("container.dumps", format="dense", bytes=enc.n_bytes):
        head = _dense_head(enc, checksum)
        bbits = np.asarray(enc.block_bits, dtype=np.uint32).tobytes()
        with span("container.words"):
            words = np.ascontiguousarray(
                enc.stream_words[: cdiv(enc.total_bits, 32)], np.uint32)
            payload = _payload_buffer(words.size)
            _copy_words(payload, words)
            payload = payload.view(np.uint8)
        crc = _crc(payload, checksum)
        with span("container.join"):
            return b"".join([head, bbits, payload, crc])


def container_version(blob: bytes) -> int:
    if len(blob) < _HEADER.size or blob[:4] != MAGIC:
        raise ValueError("not an HTZ container")
    return _HEADER.unpack_from(blob, 0)[1]


def _header(blob: bytes) -> tuple:
    if len(blob) < _HEADER.size:
        raise ValueError(
            f"not an HTZ container: {len(blob)} bytes < header size")
    fields = _HEADER.unpack_from(blob, 0)
    if fields[0] != MAGIC:
        raise ValueError(f"not an HTZ container (magic {fields[0]!r})")
    return fields


def _check_payload(blob: bytes, flags: int, pay_off: int,
                   pay_len: int) -> None:
    """Raise on a truncated payload, or on a CRC mismatch when the CRC
    flag is set."""
    if len(blob) < pay_off + pay_len:
        raise ValueError("truncated HTZ container")
    if not flags & FLAG_CRC32:
        return
    if len(blob) < pay_off + pay_len + 4:
        raise ValueError("truncated HTZ container (missing payload CRC)")
    want = struct.unpack_from("<I", blob, pay_off + pay_len)[0]
    with span("container.crc"):
        got = _crc32(memoryview(blob)[pay_off: pay_off + pay_len],
                     _bounds(pay_len))
    if got != want:
        raise ValueError(
            f"HTZ payload CRC mismatch (stored {want:#010x}, computed "
            f"{got:#010x}) — container corrupt")


def loads(blob: bytes) -> Encoded:
    """Deserialize container bytes (version 1) back to an Encoded stream,
    under a root span "container.loads" (children container.crc and
    container.words, the payload's swap into a new host-order array)."""
    _, ver, flags, n_bytes, block_bytes, max_code_len, total_bits, nb = \
        _header(blob)
    if ver != VERSION:
        raise ValueError(f"unsupported container version {ver}")
    with span("container.loads", format="dense", bytes=n_bytes):
        return _loads(blob, flags, n_bytes, block_bytes, max_code_len,
                      total_bits, nb)


def _loads(blob: bytes, flags: int, n_bytes: int, block_bytes: int,
           max_code_len: int, total_bits: int, nb: int) -> Encoded:
    pay_off = overhead_bytes(nb)
    n_words = cdiv(total_bits, 32)
    _check_payload(blob, flags, pay_off, 4 * n_words)
    off = _HEADER.size
    lens = np.frombuffer(blob, dtype=np.uint8, count=256, offset=off)
    block_bits = np.frombuffer(blob, dtype=np.uint32, count=nb,
                               offset=off + 256).astype(np.int32)
    with span("container.words"):
        words = np.empty(n_words, np.uint32)
        _copy_words(words, np.frombuffer(blob, dtype=">u4", count=n_words,
                                         offset=pay_off))
    return Encoded(stream_words=words, total_bits=total_bits,
                   block_bits=block_bits,
                   codebook=Codebook.from_lengths(lens.astype(np.int32)),
                   n_bytes=n_bytes,
                   config=CodecConfig(block_bytes=block_bytes,
                                      max_code_len=max_code_len))


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dumps_device(enc: ResidentEncoded | PlanesEncoded,
                 checksum: bool = True) -> torch.Tensor:
    """dumps' bytes for a ResidentEncoded, or a version 4 container for a
    PlanesEncoded, as a uint8 tensor on its device, under a root span
    "container.dumps" with device=True (children container.head: the
    head's 296 bytes up and the bit counts copied; container.crc: the
    stream's swap and CRC, waited for; for a PlanesEncoded
    container.plane: the plane's copy and its CRC, waited for)."""
    planes = isinstance(enc, PlanesEncoded)
    stream = enc.exponent if planes else enc
    device = stream.stream_words.device
    nb, n_words = stream.block_bits.numel(), cdiv(stream.total_bits, 32)
    pay_off = overhead_bytes(nb)
    end = pay_off + 4 * n_words
    plane = enc.n if planes else 0
    with span("container.dumps", format="dense", bytes=stream.n_bytes
              + plane, device=True):
        buf = torch.empty(end + plane + 4 * checksum, dtype=torch.uint8,
                          device=device)
        with span("container.head"):
            head = np.frombuffer(_dense_head(
                stream, checksum, PLANES_VERSION if planes else VERSION),
                np.uint8)
            to_device(head, out=buf[: head.size])
            buf[head.size: pay_off].view(torch.int32).copy_(stream.block_bits)
        # the CRC field, or a scratch word without a checksum; a v4
        # container's stream CRC goes to crcs[0], which the plane's goes on
        # from (crcs[1] is scratch)
        field = (buf[end + plane:] if checksum else
                 torch.empty(4, dtype=torch.uint8, device=device))
        crcs = torch.empty(2 * planes, dtype=torch.int32, device=device)
        with span("container.crc"):
            swap_crc32(stream.stream_words[:n_words],
                       buf[pay_off: end].view(torch.int32),
                       crcs[:1] if planes else field.view(torch.int32), True)
            _synchronize(device)
        if planes:
            with span("container.plane"):
                _plane_out(enc.sign_mantissa, buf[end: end + plane], crcs,
                           field, checksum)
                _synchronize(device)
    return buf


def _plane_out(plane: torch.Tensor, out: torch.Tensor, crcs: torch.Tensor,
               field: torch.Tensor, checksum: bool) -> None:
    """Copy the raw plane into its place in a container, `out`, and write
    to the 4 bytes `field` the CRC-32 of the stream and the plane, going on
    from the stream's in crcs[0] (crcs[1] is scratch).  A plane at an
    address that is not 4-byte aligned is copied first: its words are read
    as such.  Where its length is not a multiple of 4, the CRC of its
    whole words and its last bytes come down, and the field goes up."""
    if plane.data_ptr() % 4:
        plane = plane.clone()
    whole = plane.numel() // 4 * 4
    tail = plane[whole:]
    copy_crc32(plane[:whole].view(torch.int32),
               out[:whole].view(torch.int32),
               crcs[1:2] if tail.numel() else field.view(torch.int32),
               crcs[:1])
    if tail.numel():
        out[whole:].copy_(tail)
        if checksum:
            both = to_host(torch.cat([crcs[1:2].view(torch.uint8), tail]))
            value = zlib.crc32(both[4:].tobytes(),
                               int(both[:4].view("<u4")[0]))
            to_device(np.array([value], "<u4").view(np.uint8), out=field)


def loads_device(buf: torch.Tensor) -> ResidentEncoded | PlanesEncoded:
    """loads for container bytes (version 1, or 4) in a uint8 tensor on a
    device: a ResidentEncoded on that device (a PlanesEncoded whose plane
    is a view of buf, or of its copy where buf is not 4-byte aligned),
    under a root span "container.loads" with device=True (children
    container.head: the head's 296 bytes down and parsed; container.crc:
    the payload's swap to host order and its CRC, checked on the host;
    for version 4 the stream's CRC is waited for, and container.plane
    goes on over the plane and checks).  Raises ValueError as loads does:
    a bad magic or version, a truncated buffer, a CRC mismatch."""
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError(f"loads_device: want a 1-D uint8 tensor, got "
                         f"{buf.dtype} of shape {tuple(buf.shape)}")
    if buf.data_ptr() % 4:
        buf = buf.clone()                 # the payload is read as words
    device, head_size = buf.device, _HEADER.size + 256
    with span("container.loads", format="dense", device=True) as rec:
        with span("container.head"):
            head = to_host(buf[:head_size]).tobytes()
            _, ver, flags, n_bytes, block_bytes, max_code_len, total_bits, \
                nb = _header(head)
            if ver not in (VERSION, PLANES_VERSION):
                raise ValueError(f"unsupported container version {ver}")
            if len(head) < head_size:
                raise ValueError("truncated HTZ container")
            planes = ver == PLANES_VERSION
            plane = n_bytes if planes else 0
            if rec is not None:
                rec.attrs["bytes"] = n_bytes + plane
            pay_off = overhead_bytes(nb)
            end = pay_off + 4 * cdiv(total_bits, 32)
            if buf.numel() < end + plane:
                raise ValueError("truncated HTZ container")
            crc_flag = bool(flags & FLAG_CRC32)
            if crc_flag and buf.numel() < end + plane + 4:
                raise ValueError(
                    "truncated HTZ container (missing payload CRC)")
            lens = np.frombuffer(head, np.uint8, 256, _HEADER.size)
        stored = buf[end + plane: end + plane + 4 * crc_flag]
        with span("container.crc"):
            words = torch.empty((end - pay_off) // 4, dtype=torch.int32,
                                device=device)
            crcs = torch.empty(2, dtype=torch.int32, device=device)
            swap_crc32(buf[pay_off: end].view(torch.int32), words, crcs[:1],
                       False)
            if planes:
                _synchronize(device)
            elif crc_flag:
                _check_crc(crcs[:1], stored)
        if planes:
            sign_mantissa = buf[end: end + plane]
            with span("container.plane"):
                _plane_in(sign_mantissa, crcs, stored)
        block_bits = buf[head_size: pay_off].view(torch.int32).clone()
    exponent = ResidentEncoded(
        stream_words=words, total_bits=total_bits, block_bits=block_bits,
        codebook=Codebook.from_lengths(lens.astype(np.int32)),
        n_bytes=n_bytes,
        config=CodecConfig(block_bytes=block_bytes,
                           max_code_len=max_code_len))
    return (PlanesEncoded(exponent, sign_mantissa, n_bytes) if planes
            else exponent)


def _check_crc(got: torch.Tensor, stored: torch.Tensor,
               tail: torch.Tensor | None = None) -> None:
    """Raise unless the (1,) int32 CRC got, gone on over the bytes `tail`
    where given, is the 4 stored bytes; they come down in one copy."""
    parts = [got.view(torch.uint8), stored]
    if tail is not None:
        parts.append(tail)
    both = to_host(torch.cat(parts))
    value, want = (int(v) for v in both[:8].view("<u4"))
    if tail is not None:
        value = zlib.crc32(both[8:].tobytes(), value)
    if value != want:
        raise ValueError(
            f"HTZ payload CRC mismatch (stored {want:#010x}, "
            f"computed {value:#010x}) — container corrupt")


def _plane_in(plane: torch.Tensor, crcs: torch.Tensor,
              stored: torch.Tensor) -> None:
    """The CRC of a loaded plane, in place, going on from the stream's in
    crcs[0], checked against the stored bytes (none: no CRC)."""
    if not stored.numel():
        return
    whole = plane.numel() // 4 * 4
    copy_crc32(plane[:whole].view(torch.int32), None, crcs[1:2], crcs[:1])
    _check_crc(crcs[1:2], stored, plane[whole:] if whole < plane.numel()
               else None)


def dumps_wide(enc: WideEncoded, checksum: bool = True) -> bytes:
    """Serialize a WideEncoded stream (container version 3), under a root
    span "container.dumps" (children container.words, the payload's words
    read in place; container.crc; container.join, the one copy into the
    bytes returned)."""
    nt = len(enc.tile_words)
    bases = np.asarray(enc.bases)
    if bases.shape != (nt, ROUNDS):
        raise ValueError("bases shape mismatch")
    with span("container.dumps", format="wide", bytes=enc.n_bytes):
        head = _head(enc, WIDE_VERSION, checksum, TILE_BYTES,
                     int(enc.payload_words.size) * 32, nt)
        counts = np.asarray(enc.tile_words, dtype="<u4").tobytes()
        with span("container.words"):
            payload = np.ascontiguousarray(enc.payload_words,
                                           "<u4").view(np.uint8)
        crc = _crc(payload, checksum)
        with span("container.join"):
            return b"".join([head, counts,
                             bases.astype("<u2").tobytes(), payload, crc])


def loads_wide(blob: bytes) -> WideEncoded:
    """Deserialize container version 3 to a WideEncoded stream, under a
    root span "container.loads" (children container.crc and
    container.words: the payload's words read in place from a bytes
    object, which cannot change under them, as a read-only array, and
    copied once from any other buffer).  The tile size and the
    code-length cap are checked: either out of range would misdecode
    without an error."""
    _, ver, flags, n_bytes, tile, max_code_len, bits, nt = _header(blob)
    with span("container.loads", format="wide", bytes=n_bytes):
        return _loads_wide(blob, ver, flags, n_bytes, tile, max_code_len,
                           bits, nt)


def _loads_wide(blob: bytes, ver: int, flags: int, n_bytes: int, tile: int,
                max_code_len: int, bits: int, nt: int) -> WideEncoded:
    if ver != WIDE_VERSION:
        raise ValueError(f"not a version-{WIDE_VERSION} (wide) HTZ container")
    if tile != TILE_BYTES:
        raise ValueError(
            f"wide container tile size {tile} != supported {TILE_BYTES}")
    if not 1 <= max_code_len <= MAXLEN:
        raise ValueError(
            f"wide container max_code_len {max_code_len} outside "
            f"[1, {MAXLEN}]")
    pay_off = overhead_bytes(nt) + 2 * ROUNDS * nt
    n_words = bits // 32
    _check_payload(blob, flags, pay_off, 4 * n_words)
    off = _HEADER.size
    lens = np.frombuffer(blob, dtype=np.uint8, count=256, offset=off)
    if lens.max() > MAXLEN:
        raise ValueError(f"wide container holds {int(lens.max())}-bit codes; "
                         f"the format takes at most {MAXLEN}")
    off += 256
    counts = np.frombuffer(blob, dtype="<u4", count=nt,
                           offset=off).astype(np.int32)
    off += 4 * nt
    bases = np.frombuffer(blob, dtype="<u2", count=nt * ROUNDS,
                          offset=off).astype(np.int32).reshape(nt, ROUNDS)
    with span("container.words"):
        words = np.frombuffer(blob, dtype="<u4", count=n_words,
                              offset=pay_off)
        if not isinstance(blob, bytes):
            words, src = np.empty(n_words, np.uint32), words
            _copy_words(words, src)
    return WideEncoded(payload_words=words, tile_words=counts, bases=bases,
                       codebook=Codebook.from_lengths(lens.astype(np.int32)),
                       n_bytes=n_bytes,
                       config=CodecConfig(max_code_len=max_code_len))


def dump(enc: Encoded | WideEncoded, path: str, checksum: bool = True) -> int:
    """Write either container version, by the type of `enc`."""
    blob = (dumps_wide(enc, checksum) if isinstance(enc, WideEncoded)
            else dumps(enc, checksum))
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def load(path: str) -> Encoded | WideEncoded:
    """Load either container version (dense Encoded or WideEncoded)."""
    with open(path, "rb") as f:
        blob = f.read()
    return (loads_wide(blob) if container_version(blob) == WIDE_VERSION
            else loads(blob))
