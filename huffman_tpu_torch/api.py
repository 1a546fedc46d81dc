"""Single-device codec API (counterpart of huffman_tpu/api.py, dense format).

encode on a CUDA device takes the kernel path, the JAX package's driver:
  - the codebook is given, a model's, or built from a device histogram:
    of every SAMPLE_EVERY-th block only at SAMPLE_MIN_BYTES or more, the
    sample gathered on the host, so that only it crosses before the
    codebook exists;
  - above CHUNK_BLOCKS blocks the input goes to the device chunk by chunk
    (stage_chunks: a ring of pinned host buffers and a side stream), K1 of
    each chunk running while the next one copies; smaller inputs go in one
    copy;
  - K1 runs at each capacity of _cap_schedule until one holds every
    block: a narrow speculative capacity first where the codebook's
    expected rate clears it, then the safe one, on the device-resident
    input;
  - a byte that K1 finds without a code (MISS_FLAG) makes a sampled
    codebook be rebuilt from the exact histogram of the resident input,
    and K1 runs again; with a given codebook it raises ValueError;
  - the per-block bit counts go to the host (the checks, the total, the
    container), then the int64 offset scan and pack at the capacity that
    held, and the stream words to the host.
Elsewhere encode makes one exact pass at cfg.capacity_words, as the JAX
package does off the TPU; on the CPU the kernel wrappers run their plain
versions.  _kernel_path is the gate (the CPU tests patch it).  Nothing
detects a device on its own: every function takes `device`.
decode: offset scan -> K4 decode of every block (device) -> bytes.
Card-resident data: encode of a uint8 tensor on the codec's device runs
the same driver on the resident rows (the sample gathered on the device,
no staging, the tail block padded only where the input ends inside it)
and returns a ResidentEncoded, whose stream words and block bit counts
stay on the device; decode of a ResidentEncoded returns a uint8 tensor
there.  Only the histograms, three numbers a K1 pass (counts_on_device:
whether a byte had no code, the largest block and the total) and the
codebook tables cross.
Every host-device copy of the codec goes through to_device and to_host,
which count its bytes (utils/timing.copied), and each call's stages run
in spans (utils/timing.span), recorded only under torch.profiler.  A copy
of PINNED_MIN_BYTES or more from a CUDA device lands in a pinned host
block that host_pool keeps from call to call (HostPool).

Left out against the JAX package, as Mosaic machinery (ROADMAP.md): the
speculative merge tree with its patch overlay (K1 has no merge tree) and
the pow2 block buckets, which only reuse compiles.
"""

from __future__ import annotations

import dataclasses
import threading
import warnings
import weakref
from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch

from .codebook import Codebook
from .config import DEFAULT_CONFIG, CodecConfig, cdiv
from .ops import histogram as hist_ops
from .ops.cuda import dense_decode as k_decode
from .ops.cuda import encode as k_encode
from .ops.cuda import pack2 as k_pack
from .ops.decode import table_entries
from .ops.encode import BITS_MASK, MISS_FLAG
from .ops.scan import exclusive_bit_offsets
from .utils import timing
from .utils.timing import span

if TYPE_CHECKING:
    from .models.base import CodebookModel

# The kernel path's policies, as in the JAX package.  From SAMPLE_MIN_BYTES
# on, the histogram reads every SAMPLE_EVERY-th block (a miss costs one
# exact histogram and one more K1 pass); above CHUNK_BLOCKS blocks (16 MiB
# at 1 KiB blocks) the input is staged CHUNK_BLOCKS blocks at a time.
SAMPLE_MIN_BYTES = 4 * 1024 * 1024
SAMPLE_EVERY = 16
CHUNK_BLOCKS = 16384
# Pinned host buffers of the staging ring: the host fills one while the
# other's copy runs.  They come from PyTorch's caching host allocator,
# which keeps freed pinned blocks for the next call, so the ring is not
# cached here.
PINNED_RING = 2
# A device-to-host copy of PINNED_MIN_BYTES (one staging chunk) or more
# lands in a pinned host block that host_pool keeps from call to call;
# smaller ones (bit counts, histograms, totals) go to fresh pageable
# memory.  The pool pins at most PINNED_POOL_BYTES: the blocks of a 1 GiB
# roundtrip (its 1 GiB output, its stream's 512 MiB) and of a caller that
# holds two more outputs, so that a caller that keeps every result pins
# no more of the host's memory than that, and copies as before past it.
PINNED_MIN_BYTES = 16 * 1024 * 1024
PINNED_POOL_BYTES = 4 * 1024**3


@dataclasses.dataclass(frozen=True)
class Encoded:
    """An encoded stream plus everything needed to decode it: the in-memory
    form of the .htz v1 container."""
    stream_words: np.ndarray      # (ceil(total_bits/32),) uint32
    total_bits: int
    block_bits: np.ndarray        # (NB,) int32
    codebook: Codebook
    n_bytes: int
    config: CodecConfig

    @property
    def stream_bytes(self) -> np.ndarray:
        """MSB-first byte view (bit-comparable with the golden codec)."""
        from .golden.numpy_codec import words_to_packed_bytes
        return words_to_packed_bytes(self.stream_words, self.total_bits)

    @property
    def ratio(self) -> float:
        return (self.total_bits / 8) / max(self.n_bytes, 1)


@dataclasses.dataclass(frozen=True)
class ResidentEncoded:
    """Encoded's sibling for data that lives on a device: what encode
    returns for a tensor on the codec's device, and what
    container.loads_device reads back.  stream_words is the (ceil
    (total_bits/32),) int32 tensor of the stream's host-order words and
    block_bits the (NB,) int32 bit counts, both on the device; the rest is
    Encoded's, on the host."""
    stream_words: torch.Tensor
    total_bits: int
    block_bits: torch.Tensor
    codebook: Codebook
    n_bytes: int
    config: CodecConfig

    @property
    def ratio(self) -> float:
        return (self.total_bits / 8) / max(self.n_bytes, 1)


@dataclasses.dataclass
class EncodeTrace:
    """How one encode ran: whether its codebook came from a sample, and was
    rebuilt after a miss; K1's capacity (words) at each pass over the
    blocks, in order, the last one the capacity that held; and the chunks
    the input was staged in (0: one copy)."""
    sampled: bool = False
    rebuilt: bool = False
    capacities_tried: list = dataclasses.field(default_factory=list)
    chunks: int = 0


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)


def _resident(data, device: torch.device) -> bool:
    """Whether data is a tensor on `device` (any index where device names
    none), which encode keeps there."""
    return (isinstance(data, torch.Tensor) and data.device.type == device.type
            and device.index in (None, data.device.index))


def _resident_u8(data: torch.Tensor) -> torch.Tensor:
    if data.dtype != torch.uint8:
        raise ValueError(f"encode: want a uint8 tensor, got {data.dtype}")
    return data.reshape(-1)


def _host_tensor(arr) -> torch.Tensor:
    """A CPU tensor over a host array's memory, no copy made.  Read-only
    arrays (views of bytes objects) are fine: the tensor is only read."""
    if isinstance(arr, torch.Tensor):
        return arr
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.asarray(arr))


def _count(kind: str, host: torch.Tensor, nbytes: int) -> None:
    memory = "pinned" if host.is_pinned() else "pageable"
    timing.copied[f"{kind}.{memory}"].n += nbytes


def _pinned(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


class HostPool:
    """Host blocks that large device-to-host copies land in, kept from
    call to call: a fresh pageable destination faults in its pages at
    every call, and the CUDA driver stages a copy to pageable memory
    through buffers of its own besides.

    take(dtype, shape) hands out a host array over the smallest free block
    that fits, or over a new one while the blocks stay within `limit`
    bytes, and otherwise returns None: the caller then copies as before.
    A block is free again once no array over it is left: each view of the
    array handed out refers to that array (numpy makes a view's base the
    first array up the chain whose base is no array, here a tensor), so
    the pool's weak reference to it dies with the last of them.  A block
    held is never handed out.  Blocks are kept for the process's life;
    PyTorch's caching host allocator rounds a pinned request up to a
    power of two, so a block is taken at that size.  `alloc(nbytes)` makes
    a block (_pinned; the CPU tests pass a plain one).  The bytes asked
    for are counted in timing.host_blocks as reused, new or declined."""

    def __init__(self, limit: int, alloc=_pinned):
        self.limit, self.alloc = limit, alloc
        self.blocks: list[list] = []        # [block, weakref to its array]
        self._lock = threading.Lock()

    @property
    def pinned_bytes(self) -> int:
        return sum(block.numel() for block, _ in self.blocks)

    def take(self, dtype: torch.dtype, shape: tuple
             ) -> tuple[torch.Tensor, np.ndarray] | None:
        """(a tensor, the host array) of `shape` and `dtype` over one
        block, or None."""
        nbytes = int(np.prod(shape)) * dtype.itemsize
        size = 1 << (nbytes - 1).bit_length()
        with self._lock:
            free = [e for e in self.blocks
                    if e[0].numel() >= nbytes and e[1]() is None]
            if free:
                entry = min(free, key=lambda e: e[0].numel())
                kind = "reused"
            elif self.pinned_bytes + size <= self.limit:
                entry, kind = [self.alloc(size), None], "new"
                self.blocks.append(entry)
            else:
                timing.host_blocks["declined"].n += nbytes
                return None
            timing.host_blocks[kind].n += nbytes
            dst = entry[0][:nbytes].view(dtype).view(shape)
            arr = dst.numpy()
            entry[1] = weakref.ref(arr)
            return dst, arr


host_pool = HostPool(PINNED_POOL_BYTES)


def _host_block_path(device: torch.device, nbytes: int) -> bool:
    """Whether a device-to-host copy of nbytes from `device` asks host_pool
    for a block: from a CUDA device, PINNED_MIN_BYTES or more.  The CPU
    tests patch it."""
    return device.type == "cuda" and nbytes >= PINNED_MIN_BYTES


def host_block(dtype: torch.dtype, shape: tuple, device: torch.device
               ) -> tuple[torch.Tensor, np.ndarray] | None:
    """host_pool.take(dtype, shape) for a copy from `device` that
    _host_block_path admits, else None."""
    nbytes = int(np.prod(shape)) * dtype.itemsize
    if not _host_block_path(device, nbytes):
        return None
    return host_pool.take(dtype, shape)


def to_device(src, device=None, out: torch.Tensor | None = None,
              non_blocking: bool = False) -> torch.Tensor:
    """Copy a host array or CPU tensor to `device`, or into the tensor
    `out`, and return the copy; every host-to-device copy of the codec
    goes through here, its bytes counted in timing.copied by the host
    memory's kind (pinned or pageable).  The count is made whatever the
    device: on the CPU the copy is the codec's host/device boundary all
    the same."""
    host = _host_tensor(src)
    _count("h2d", host, host.numel() * host.element_size())
    if out is None:
        return host.to(device, non_blocking=non_blocking)
    return out.copy_(host, non_blocking=non_blocking)


def to_host(src: torch.Tensor, out=None) -> np.ndarray:
    """Copy a device tensor to host memory, into the host array or CPU
    tensor `out` where given, and return the host array; every
    device-to-host copy of the codec goes through here, counted as
    to_device's are.  Without `out`, a large copy from a CUDA device lands
    in a block of host_pool (host_block), any other in fresh memory."""
    if out is None:
        pooled = host_block(src.dtype, tuple(src.shape), src.device)
        if pooled is None:
            host = src.cpu()
            _count("d2h", host, host.numel() * host.element_size())
            return host.numpy()
        dst, arr = pooled
        _count("d2h", dst, dst.numel() * dst.element_size())
        dst.copy_(src)
        return arr
    dst = _host_tensor(out)
    _count("d2h", dst, src.numel() * src.element_size())
    dst.copy_(src)
    return dst.numpy()


def valid_per_block(n_bytes: int, num_blocks: int, block_bytes: int,
                    ) -> np.ndarray:
    """Real byte count of each block: block_bytes for full blocks, the
    remainder for the final partial block."""
    starts = np.arange(num_blocks, dtype=np.int64) * block_bytes
    return np.clip(n_bytes - starts, 0, block_bytes).astype(np.int32)


def valid_on(n_bytes: int, num_blocks: int, block_bytes: int,
             device: torch.device) -> torch.Tensor:
    """valid_per_block, made on `device` (nothing crosses)."""
    starts = torch.arange(num_blocks, dtype=torch.int64,
                          device=device) * block_bytes
    return (n_bytes - starts).clamp_(0, block_bytes).to(torch.int32)


def resident_blocks(x: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """(NB, block_bytes) uint8 blocks of the 1-D device tensor x: a view of
    x where it fills them from a 16-byte aligned address, else a copy on
    its device, zero past x (span encode.pad).  K1 reads the blocks as
    words, and its warp route in 16-byte pieces: a slice of a buffer at
    any other address is copied, not handed to it."""
    nb, bb = cfg.num_blocks(x.numel()), cfg.block_bytes
    if x.numel() == nb * bb and x.data_ptr() % 16 == 0:
        return x.view(nb, bb)
    with span("encode.pad"):
        rows = torch.empty(nb * bb, dtype=torch.uint8, device=x.device)
        rows[: x.numel()].copy_(x)
        rows[x.numel():].zero_()
    return rows.view(nb, bb)


def device_rows(arr: np.ndarray, n_rows: int, row_bytes: int,
                device: torch.device):
    """(n_rows, row_bytes) uint8 rows of `arr` on `device`, zero past it
    (arr holds at most n_rows * row_bytes bytes), and the (n_rows,) int32
    valid byte counts.  The input goes to the device as it is: no padded
    copy is made on the host."""
    n = arr.size
    rows = torch.empty(n_rows * row_bytes, dtype=torch.uint8, device=device)
    to_device(arr, out=rows[:n])
    rows[n:].zero_()
    valid = to_device(valid_per_block(n, n_rows, row_bytes), device)
    return rows.view(n_rows, row_bytes), valid


def device_blocks(arr: np.ndarray, cfg: CodecConfig, device: torch.device):
    """(NB, block_bytes) uint8 blocks on `device`, zero past the input, and
    the (NB,) int32 valid byte counts."""
    return device_rows(arr, cfg.num_blocks(arr.size), cfg.block_bytes, device)


def stage_chunks(arr: np.ndarray, rows: torch.Tensor, chunk_bytes: int):
    """Copy arr into the flat uint8 buffer `rows` (zero past arr),
    chunk_bytes at a time, yielding each chunk's range [lo, hi) of rows
    once the current stream may read it.

    On a CUDA device each chunk goes through one of PINNED_RING pinned
    host buffers and is copied on a side stream: the caller's work on
    chunk i, enqueued on the current stream behind an event, overlaps the
    host's copy of chunk i + 1 into the next buffer and that buffer's
    copy to the device.  A buffer is refilled only once its last copy has
    completed.  On the CPU the copies are plain, and no CUDA call is made.
    Each chunk's host work runs in a span encode.stage.
    """
    n, total = arr.size, rows.numel()
    spans = [(lo, min(lo + chunk_bytes, total))
             for lo in range(0, total, chunk_bytes)]
    if rows.device.type != "cuda":
        for lo, hi in spans:
            with span("encode.stage"):
                if lo < n:
                    to_device(arr[lo: min(hi, n)], out=rows[lo: min(hi, n)])
                rows[max(lo, n): hi].zero_()
            yield lo, hi
        return
    compute = torch.cuda.current_stream(rows.device)
    side = torch.cuda.Stream(rows.device)
    side.wait_stream(compute)           # rows was allocated on `compute`
    rows.record_stream(side)            # and is written on `side`
    ring = [torch.empty(chunk_bytes, dtype=torch.uint8, pin_memory=True)
            for _ in range(PINNED_RING)]
    copied = [None] * PINNED_RING
    for i, (lo, hi) in enumerate(spans):
        slot = i % PINNED_RING
        with span("encode.stage"):
            if copied[slot] is not None:
                copied[slot].synchronize()
            with torch.cuda.stream(side):
                if lo < n:
                    buf = ring[slot][: min(hi, n) - lo]
                    buf.copy_(_host_tensor(arr[lo: min(hi, n)]))
                    to_device(buf, out=rows[lo: min(hi, n)],
                              non_blocking=True)
                rows[max(lo, n): hi].zero_()
                copied[slot] = torch.cuda.Event()
                copied[slot].record(side)
            compute.wait_event(copied[slot])
        yield lo, hi


def codebook_tensors(cb: Codebook, device: torch.device):
    """The kernels' (256,) int32 codes (uint32 bit patterns) and lengths."""
    if cb.max_len > 24:
        raise ValueError(f"codebook has {cb.max_len}-bit codes; at most 24")
    codes = to_device(np.ascontiguousarray(cb.codes, np.uint32)
                      .view(np.int32), device)
    return codes, to_device(np.ascontiguousarray(cb.lengths, np.int32),
                            device)


def _codebook_for(blocks: torch.Tensor, n: int, cfg: CodecConfig) -> Codebook:
    freqs = to_host(hist_ops.histogram(blocks, n))
    return Codebook.from_frequencies_auto(freqs, cfg.max_code_len,
                                          cfg.narrow_tol)


def sample_rows(arr: np.ndarray, cfg: CodecConfig, every: int) -> np.ndarray:
    """The bytes of blocks 0, every, 2 * every, ... of arr, in order, as
    one host array.  Only the last block can be partial, so these are the
    first valid[::every].sum() bytes of the sampled (zero-padded) rows."""
    bb = cfg.block_bytes
    full = arr.size // bb
    rows = arr[: full * bb].reshape(full, bb)[::every]
    if arr.size > full * bb and full % every == 0:
        return np.concatenate([rows.reshape(-1), arr[full * bb:]])
    return np.ascontiguousarray(rows).reshape(-1)


def resident_sample(x: torch.Tensor, cfg: CodecConfig,
                    every: int) -> torch.Tensor:
    """sample_rows of the 1-D device tensor x, gathered on its device."""
    bb = cfg.block_bytes
    full = x.numel() // bb
    rows = x[: full * bb].view(full, bb)[::every].reshape(-1)
    if x.numel() > full * bb and full % every == 0:
        return torch.cat([rows, x[full * bb:]])
    return rows


def build_codebook(data, cfg: CodecConfig = DEFAULT_CONFIG, device="cuda",
                   sample_every: int = 1) -> Codebook:
    """Histogram on `device` + host canonical codebook, with the
    cfg.narrow_tol cap policy of the JAX package.  With sample_every k > 1
    only every k-th block is counted (sample_rows, gathered on the host,
    or resident_sample for a tensor on `device`): the codebook may then
    lack codes for bytes outside the sample, which K1 flags."""
    device = torch.device(device)
    if _resident(data, device):
        x = _resident_u8(data)
        if sample_every > 1:
            x = resident_sample(x, cfg, sample_every)
        return _codebook_for(x, x.numel(), cfg)
    arr = _as_u8(data)
    if sample_every > 1:
        sample = to_device(sample_rows(arr, cfg, sample_every), device)
        return _codebook_for(sample, sample.numel(), cfg)
    blocks, _ = device_blocks(arr, cfg, device)
    return _codebook_for(blocks, arr.size, cfg)


def _kernel_path(device: torch.device) -> bool:
    """Whether encode takes the kernel path (sampled codebook, capacity
    schedule, chunked staging): on a CUDA device.  The JAX package's
    _pallas_ok; the CPU tests patch it."""
    return device.type == "cuda"


def _kernel_mcl(cb: Codebook) -> int:
    """The codebook's longest code, rounded up to 4, 8, 12, 16 (the JAX
    package's buckets) or 24 (the port's longest codes).  It bounds a
    block's bits, and with them the safe capacity (_cap_schedule)."""
    actual = int(np.max(cb.lengths))
    for b in (4, 8, 12, 16):
        if actual <= b:
            return b
    return 24


def _cap_schedule(cfg: CodecConfig, kmcl: int,
                  est_bpb: float | None) -> list[int]:
    """K1's capacities (words) to try, narrowest first.

    The last is safe: cfg.capacity_words, or less where codes of at most
    kmcl bits bound a block below it.  A speculative capacity of
    cfg.spec_bits_per_byte bits a byte goes first when the codebook's
    expected rate (Codebook.est_bpb) clears it by 0.75 bits a byte; encode
    goes on to the safe one if some block's exact bit count exceeds it.
    The JAX package rounds both up to its 128-word lanes and the port does
    not, so the two agree where both are whole multiples of 128 words:
    at 1 KiB blocks, the only size the JAX package runs this at, with
    capacity and speculative rates that are multiples of 4 bits a byte.
    """
    safe = min(cfg.capacity_words, cdiv(kmcl * cfg.block_bytes, 32))
    spec = cdiv(cfg.spec_bits_per_byte * cfg.block_bytes, 32)
    if (cfg.spec_bits_per_byte > 0 and est_bpb is not None
            and est_bpb <= cfg.spec_bits_per_byte - 0.75 and spec < safe):
        return [spec, safe]
    return [safe]


def empty_encoded(cfg: CodecConfig, codebook: Codebook | None) -> Encoded:
    """The Encoded of an empty input: no words, one block of 0 bits."""
    return Encoded(np.zeros(0, np.uint32), 0, np.zeros(1, np.int32),
                   codebook or Codebook.from_lengths(np.zeros(256)), 0, cfg)


def block_bits_of(bits_raw: np.ndarray) -> np.ndarray:
    """K1's raw per-block counts -> int32 bit counts, raising ValueError for
    a byte with no code (MISS_FLAG)."""
    raw = bits_raw.view(np.uint32)
    if (raw & MISS_FLAG).any():
        raise ValueError("input contains symbols absent from the codebook")
    return raw.astype(np.int32)


def check_overflow(block_bits: np.ndarray, cfg: CodecConfig) -> np.ndarray:
    """block_bits, raising OverflowError for a block past cfg's capacity
    (with cfg.check_overflow)."""
    cap = cfg.capacity_words
    if cfg.check_overflow and (block_bits > cap * 32).any():
        bad = int(np.argmax(block_bits > cap * 32))
        raise OverflowError(
            f"block {bad} needs {int(block_bits[bad])} bits > capacity "
            f"{cap * 32}; raise config.capacity_bits_per_byte")
    return block_bits


def check_block_bits(bits_raw: np.ndarray, cfg: CodecConfig) -> np.ndarray:
    """block_bits_of and check_overflow."""
    return check_overflow(block_bits_of(bits_raw), cfg)


def _encode_staged(arr: np.ndarray, rows: torch.Tensor, codes, lengths,
                   valid: torch.Tensor, cap: int, block_bytes: int):
    """K1 at capacity `cap` on each chunk of CHUNK_BLOCKS blocks as it
    reaches the device (stage_chunks into `rows`), each chunk writing its
    rows of one (NB, cap) output.  Returns the streams, the raw bit counts
    and the number of chunks."""
    nb = valid.numel()
    blocks = rows.view(nb, block_bytes)
    streams = torch.empty((nb, cap), dtype=torch.int32, device=rows.device)
    bits = torch.empty(nb, dtype=torch.int32, device=rows.device)
    chunks = 0
    for lo, hi in stage_chunks(arr, rows, CHUNK_BLOCKS * block_bytes):
        b0, b1 = lo // block_bytes, hi // block_bytes
        k_encode.encode_blocks(blocks[b0:b1], codes, lengths, valid[b0:b1],
                               cap, out=(streams[b0:b1], bits[b0:b1]))
        chunks += 1
    return streams, bits, chunks


def encode(data, cfg: CodecConfig = DEFAULT_CONFIG,
           codebook: Codebook | None = None,
           model: "CodebookModel | None" = None,
           device="cuda") -> Encoded | ResidentEncoded:
    """Encode a byte stream on `device`.

    The codebook comes from, in this order: `codebook`, then
    `model.codebook_for(data)` (models.CodebookModel; FixedCodebook skips
    the histogram), then the per-stream build (sampled on the kernel
    path, rebuilt exactly on a miss).  A given or modelled codebook that
    lacks a code for some input byte raises ValueError.  A uint8 tensor on
    `device` is encoded where it lies, into a ResidentEncoded; any other
    data is host data, encoded into an Encoded."""
    return encode_traced(data, cfg, codebook, model, device)[0]


def encode_traced(data, cfg: CodecConfig = DEFAULT_CONFIG,
                  codebook: Codebook | None = None,
                  model: "CodebookModel | None" = None,
                  device="cuda") -> tuple[Encoded | ResidentEncoded,
                                          EncodeTrace]:
    """encode, and how it ran (EncodeTrace).  Its stages run in spans
    (utils/timing.py) under a root "encode": encode.sample,
    encode.codebook, encode.upload, one encode.pass a pass over the blocks
    (its children one encode.stage a staged chunk and encode.bits),
    encode.rebuild, encode.pack and encode.stream.  Of a tensor on
    `device` the root carries resident=True, and the stages are
    encode.sample (gathered on the device), encode.codebook, encode.pad
    (only where the input ends inside a block), encode.pass (with
    encode.bits), encode.rebuild and encode.pack."""
    device = torch.device(device)
    trace = EncodeTrace()
    if _resident(data, device):
        x = _resident_u8(data)
        if x.numel() == 0:
            return _empty_resident(cfg, codebook, x.device), trace
        with span("encode", format="dense", bytes=x.numel(), resident=True):
            return _encode_resident(x, cfg, codebook, model, trace), trace
    arr = _as_u8(data)
    n = arr.size
    if n == 0:
        return empty_encoded(cfg, codebook), trace
    with span("encode", format="dense", bytes=n):
        return _encode_traced(arr, cfg, codebook, model, device,
                              trace), trace


def _empty_resident(cfg: CodecConfig, codebook: Codebook | None,
                    device: torch.device) -> ResidentEncoded:
    enc = empty_encoded(cfg, codebook)
    return ResidentEncoded(
        torch.zeros(0, dtype=torch.int32, device=device), 0,
        torch.zeros(1, dtype=torch.int32, device=device), enc.codebook, 0,
        cfg)


def _first_book(data, cfg: CodecConfig, codebook: Codebook | None, model,
                device: torch.device, trace: EncodeTrace) -> Codebook | None:
    """The codebook before the blocks are on the device: the given one, the
    model's, or on the kernel path from SAMPLE_MIN_BYTES on the sample's
    (trace.sampled): every SAMPLE_EVERY-th block of a host array gathered
    on the host and copied up, of a device tensor gathered there.  None
    where the exact book is to be built from the blocks."""
    if codebook is None and model is not None:
        with span("encode.codebook"):
            codebook = model.codebook_for(data)
    n = data.numel() if isinstance(data, torch.Tensor) else data.size
    trace.sampled = (_kernel_path(device) and codebook is None
                     and n >= SAMPLE_MIN_BYTES)
    if not trace.sampled:
        return codebook
    with span("encode.sample"):
        sample = (resident_sample(data, cfg, SAMPLE_EVERY)
                  if isinstance(data, torch.Tensor)
                  else sample_rows(data, cfg, SAMPLE_EVERY))
    with span("encode.codebook"):
        if isinstance(sample, np.ndarray):
            sample = to_device(sample, device)
        return _codebook_for(sample, sample.numel(), cfg)


def _encode_traced(arr: np.ndarray, cfg: CodecConfig,
                   codebook: Codebook | None, model, device: torch.device,
                   trace: EncodeTrace) -> Encoded:
    n = arr.size
    kernel_path = _kernel_path(device)
    cb = _first_book(arr, cfg, codebook, model, device, trace)
    nb, bb = cfg.num_blocks(n), cfg.block_bytes
    # staging needs the codebook first: an exact one is built from the
    # whole input on the device
    staged = kernel_path and cb is not None and nb > CHUNK_BLOCKS
    first_pass = None
    with span("encode.upload"):
        if staged:
            rows = torch.empty(nb * bb, dtype=torch.uint8, device=device)
            blocks = rows.view(nb, bb)
            valid = to_device(valid_per_block(n, nb, bb), device)

            def staged_pass(codes, lengths, cap):
                streams, bits_raw, trace.chunks = _encode_staged(
                    arr, rows, codes, lengths, valid, cap, bb)
                return streams, bits_raw
            first_pass = staged_pass
        else:
            blocks, valid = device_blocks(arr, cfg, device)
    if cb is None:
        with span("encode.codebook"):
            cb = _codebook_for(blocks, n, cfg)
    cb, streams, bits_raw, counts = _k1_passes(
        cb, blocks, valid, n, cfg, kernel_path, trace.sampled, trace,
        counts_on_host, first_pass)
    stream, _ = _pack(streams, bits_raw, counts, cfg)
    with span("encode.stream"):
        words = to_host(stream).view(np.uint32)
    return Encoded(stream_words=words, total_bits=counts.total,
                   block_bits=counts.host, codebook=cb, n_bytes=n,
                   config=cfg)


def _encode_resident(x: torch.Tensor, cfg: CodecConfig,
                     codebook: Codebook | None, model,
                     trace: EncodeTrace) -> ResidentEncoded:
    """_encode_traced's driver on the rows of the device tensor x: the
    same sampling policy, capacity schedule, miss and rebuild and checks;
    the stream words and the block bit counts stay on the device."""
    n, device = x.numel(), x.device
    cb = _first_book(x, cfg, codebook, model, device, trace)
    blocks = resident_blocks(x, cfg)
    valid = valid_on(n, blocks.shape[0], cfg.block_bytes, device)
    if cb is None:
        with span("encode.codebook"):
            cb = _codebook_for(blocks, n, cfg)
    cb, streams, bits_raw, counts = _k1_passes(
        cb, blocks, valid, n, cfg, _kernel_path(device), trace.sampled,
        trace, counts_on_device)
    stream, bits = _pack(streams, bits_raw, counts, cfg)
    return ResidentEncoded(stream_words=stream, total_bits=counts.total,
                           block_bits=bits, codebook=cb, n_bytes=n,
                           config=cfg)


class PassCounts(NamedTuple):
    """What the driver reads of a K1 pass's per-block bit counts: whether a
    valid byte had no code (MISS_FLAG), and else the largest count, the
    total and, where the counts came to the host, their int32 array."""
    flagged: bool
    top: int
    total: int
    host: np.ndarray | None


def counts_on_host(bits_raw: torch.Tensor) -> PassCounts:
    """A pass's counts read on the host: they come down whole (the host
    path's Encoded keeps them)."""
    raw = to_host(bits_raw)
    if (raw.view(np.uint32) & MISS_FLAG).any():
        return PassCounts(True, 0, 0, None)
    block_bits = block_bits_of(raw)
    return PassCounts(False, int(block_bits.max()),
                      int(block_bits.astype(np.int64).sum()), block_bits)


def counts_on_device(bits_raw: torch.Tensor) -> PassCounts:
    """A pass's counts reduced on their device: the flag, the largest
    count and the total cross, 24 bytes, and the counts stay."""
    bits = bits_raw & BITS_MASK
    summary = torch.stack([(bits_raw < 0).any().to(torch.int64),
                           bits.max().to(torch.int64),
                           bits.sum(dtype=torch.int64)])
    flagged, top, total = (int(v) for v in to_host(summary))
    return PassCounts(bool(flagged), top, total, None)


def _k1_passes(cb: Codebook, blocks: torch.Tensor, valid: torch.Tensor,
               n: int, cfg: CodecConfig, kernel_path: bool, sampled: bool,
               trace: EncodeTrace, read_counts, first_pass=None):
    """K1 at each capacity of _cap_schedule until one holds every block,
    the book rebuilt from the exact histogram of the resident blocks after
    a sampled one missed; a byte without a code in any other book raises
    ValueError.  read_counts(bits_raw) reads each pass's counts
    (counts_on_host or counts_on_device); first_pass(codes, lengths, cap),
    where given, makes the first pass (the staged one).  Returns the final
    book, K1's streams and raw bit counts on the device, and the last
    pass's PassCounts."""
    device = blocks.device
    while True:
        codes, lengths = codebook_tensors(cb, device)
        sched = (_cap_schedule(cfg, _kernel_mcl(cb), cb.est_bpb)
                 if kernel_path else [cfg.capacity_words])
        for cap in sched:
            with span("encode.pass", cap=cap):
                if first_pass is not None:
                    streams, bits_raw = first_pass(codes, lengths, cap)
                    first_pass = None
                else:
                    streams, bits_raw = k_encode.encode_blocks(
                        blocks, codes, lengths, valid, cap)
                trace.capacities_tried.append(cap)
                # the host sync of a pass: the counts decide what comes
                # next and feed the checks and the total
                with span("encode.bits"):
                    counts = read_counts(bits_raw)
                missed = sampled and counts.flagged
                if missed:
                    break
                if counts.flagged:
                    raise ValueError(
                        "input contains symbols absent from the codebook")
                # counts are exact at any capacity: the speculative one
                # held if no block needs more; the last one packs regardless
                if counts.top <= cap * 32 or cap == sched[-1]:
                    break
        if not missed:
            return cb, streams, bits_raw, counts
        # a byte was seen only outside the sample: rebuild the codebook
        # from the exact histogram of the resident input and encode again
        with span("encode.rebuild"):
            cb = _codebook_for(blocks, n, cfg)
        sampled, trace.rebuilt = False, True


def _pack(streams: torch.Tensor, bits_raw: torch.Tensor,
          counts: PassCounts, cfg: CodecConfig):
    """check_overflow (the counts come down only for a block past the
    capacity, to name it), the offset scan and pack at the capacity that
    held.  Returns the stream words and the int32 bit counts on the
    device."""
    with span("encode.pack"):
        if cfg.check_overflow and counts.top > cfg.capacity_words * 32:
            check_overflow(counts.host if counts.host is not None
                           else to_host(bits_raw & BITS_MASK), cfg)
        bits = bits_raw & BITS_MASK
        offsets = exclusive_bit_offsets(bits)
        stream = k_pack.pack_blocks(streams, bits, offsets.word_base,
                                    offsets.bit_shift, cdiv(counts.total, 32))
    return stream, bits


def encode_pipeline(blocks: torch.Tensor, codes: torch.Tensor,
                    lengths: torch.Tensor, valid: torch.Tensor,
                    capacity_words: int):
    """The device part of encode on device-resident inputs: K1 -> offset
    scan -> pack, with no checks.  Returns (stream words, raw block bits)
    on the blocks' device; reading the stream's length is one host sync."""
    streams, bits_raw = k_encode.encode_blocks(blocks, codes, lengths, valid,
                                               capacity_words)
    bits = bits_raw & BITS_MASK
    offsets = exclusive_bit_offsets(bits)
    return k_pack.pack_blocks(streams, bits, offsets.word_base,
                              offsets.bit_shift,
                              int(to_host(offsets.total_words))), bits_raw


def _decode_blocks(stream_words, word_base: torch.Tensor,
                   bit_shift: torch.Tensor, valid: torch.Tensor,
                   cb: Codebook, block_bytes: int) -> torch.Tensor:
    """K4 over the blocks; stream_words a host array of uint32 words, which
    goes up, or an int32 tensor on the device already."""
    device = word_base.device
    tb = max(cb.max_len, 1)
    with span("decode.upload"):
        table = to_device(table_entries(cb, tb), device)
        stream = (stream_words if isinstance(stream_words, torch.Tensor)
                  else to_device(np.ascontiguousarray(stream_words, np.uint32)
                                 .view(np.int32), device))
    with span("decode.kernel"):
        return k_decode.decode_blocks(stream, word_base, bit_shift, valid,
                                      table, tb, block_bytes)


def decode(enc: Encoded | ResidentEncoded, device="cuda"):
    """Decode every block on `device`.  Returns the uint8 bytes.  Its
    stages run in spans under a root "decode": decode.offsets (the device
    scan), decode.upload, decode.kernel and decode.output.  A
    ResidentEncoded decodes on its tensors' device into a uint8 tensor
    there (decode_resident)."""
    if isinstance(enc, ResidentEncoded):
        return decode_resident(enc)
    if enc.n_bytes == 0:
        return np.zeros(0, np.uint8)
    with span("decode", format="dense", bytes=enc.n_bytes):
        device = torch.device(device)
        bb = enc.config.block_bytes
        nb = len(enc.block_bits)
        with span("decode.offsets"):
            bits = to_device(np.ascontiguousarray(enc.block_bits, np.int32),
                             device)
            offsets = exclusive_bit_offsets(bits)
            valid = to_device(valid_per_block(enc.n_bytes, nb, bb), device)
        out = _decode_blocks(enc.stream_words, offsets.word_base,
                             offsets.bit_shift, valid, enc.codebook, bb)
        with span("decode.output"):
            return to_host(out.reshape(-1)[: enc.n_bytes])


def decode_resident(enc: ResidentEncoded) -> torch.Tensor:
    """decode of a ResidentEncoded: its n_bytes as a uint8 tensor on its
    device, made from its device bit counts and stream words with nothing
    copied but the decode table.  The root span "decode" carries
    resident=True; its children are decode.offsets, decode.upload (the
    table) and decode.kernel."""
    device = enc.stream_words.device
    if enc.n_bytes == 0:
        return torch.zeros(0, dtype=torch.uint8, device=device)
    with span("decode", format="dense", bytes=enc.n_bytes, resident=True):
        bb = enc.config.block_bytes
        with span("decode.offsets"):
            offsets = exclusive_bit_offsets(enc.block_bits)
            valid = valid_on(enc.n_bytes, enc.block_bits.numel(), bb, device)
        out = _decode_blocks(enc.stream_words, offsets.word_base,
                             offsets.bit_shift, valid, enc.codebook, bb)
        return out.reshape(-1)[: enc.n_bytes]


def decode_block_span(enc: Encoded, b0: int, b1: int,
                      device) -> torch.Tensor:
    """K4 over blocks [b0, b1) alone: host offsets from the per-block bit
    counts (span decode.offsets), and only the span of the stream that
    covers those blocks goes to `device`.  Returns (b1 - b0, block_bytes)
    uint8 on `device`."""
    device = torch.device(device)
    bb = enc.config.block_bytes
    with span("decode.offsets"):
        bits = np.asarray(enc.block_bits, np.int64)
        ends = np.cumsum(bits)
        starts = ends - bits
        word_base = starts >> 5
        w0 = int(word_base[b0])
        words = enc.stream_words[w0: cdiv(int(ends[b1 - 1]), 32)]
        valid = valid_per_block(enc.n_bytes, len(bits), bb)[b0:b1]
        word_base = to_device(word_base[b0:b1] - w0, device)
        bit_shift = to_device((starts[b0:b1] & 31).astype(np.int32), device)
        valid = to_device(valid, device)
    return _decode_blocks(words, word_base, bit_shift, valid, enc.codebook,
                          bb)


def decode_range(enc: Encoded, start: int, stop: int,
                 device="cuda") -> np.ndarray:
    """Decode bytes [start, stop) by decoding only the blocks that cover
    them (decode_block_span), under a root span "decode" with range=True."""
    if not 0 <= start <= stop <= enc.n_bytes:
        raise ValueError(f"range [{start}, {stop}) outside "
                         f"[0, {enc.n_bytes})")
    if start == stop:
        return np.zeros(0, np.uint8)
    bb = enc.config.block_bytes
    b0, b1 = start // bb, cdiv(stop, bb)
    with span("decode", format="dense", range=True, bytes=stop - start):
        out = decode_block_span(enc, b0, b1, device)
        with span("decode.output"):
            return to_host(out.reshape(-1)[start - b0 * bb: stop - b0 * bb])


def roundtrip_ok(data, cfg: CodecConfig = DEFAULT_CONFIG,
                 device="cuda") -> bool:
    """Encode + decode on `device` and compare with the input."""
    arr = _as_u8(data)
    return bool(np.array_equal(decode(encode(arr, cfg, device=device),
                                      device=device), arr))
