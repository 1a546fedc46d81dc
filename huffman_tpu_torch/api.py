"""Single-device codec API (counterpart of huffman_tpu/api.py, dense format).

encode runs one path (_encode_core) on host data and on a uint8 tensor
on the codec's device alike.  On a CUDA device it is the JAX package's:
  - the codebook is given, a model's, or built from a device histogram:
    of every SAMPLE_EVERY-th block only from SAMPLE_MIN_BYTES on, the
    sample gathered where the data lies, so that only it crosses first;
  - host data goes up above CHUNK_BLOCKS blocks chunk by chunk through
    pinned buffers (transfer.stage_chunks), K1 of each chunk running while
    the next one copies, and in one copy below; a device tensor stays;
  - K1 runs at each of capacities() until one holds every block, a
    narrow speculative capacity first where the codebook allows it;
  - for host data a byte without a code (MISS_FLAG) makes a sampled
    codebook be rebuilt from the exact histogram of the blocks, and K1
    runs again; for a device tensor the sample's and the exact histogram
    come down together and the exact one is taken where the sample lacks
    a byte it counts, so K1 runs under the final codebook at once; a
    flagged byte under any codebook that is not host data's sampled one
    raises ValueError;
  - each pass's bit counts are reduced on the device (pass_counts: 24
    bytes cross), then the int64 offset scan and pack.
Host data's Encoded gets the stream words and bit counts down once, at
the end; a device tensor's ResidentEncoded keeps them on the device.  A
bf16 tensor on the device is split into two byte planes, DFloat11's
(arXiv:2504.11651; ops/cuda/planes.py): its exponent plane is encoded as
a uint8 tensor is, and its sign-mantissa plane is kept raw, into a
PlanesEncoded; decode merges the decoded exponents back with it.
Elsewhere encode makes one exact pass at cfg.capacity_words, as the JAX
package does off the TPU; on the CPU the kernel wrappers run their plain
versions.  _kernel_path is the gate (the CPU tests patch it); nothing
detects a device on its own.  decode: offset scan and valid counts on the
device -> K4 -> bytes, on the host for an Encoded.  Copies go through
transfer.py; stages run in spans (utils/timing.span) under torch.profiler.

Left out against the JAX package, as Mosaic machinery (ROADMAP.md): the
speculative merge tree with its patch overlay (K1 has no merge tree) and
the pow2 block buckets, which only reuse compiles.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch

from . import codebook as codebooks
from . import transfer
from .codebook import Codebook
from .config import DEFAULT_CONFIG, CodecConfig, cdiv
from .ops import histogram as hist_ops
from .ops.cuda import dense_decode as k_decode
from .ops.cuda import encode as k_encode
from .ops.cuda import pack2 as k_pack
from .ops.cuda import planes as k_planes
from .ops.decode import table_entries
from .ops.encode import BITS_MASK, MISS_FLAG
from .ops.scan import exclusive_bit_offsets
from .utils.timing import span

if TYPE_CHECKING:
    from .models.base import CodebookModel

# The kernel path's policies, as in the JAX package.  From SAMPLE_MIN_BYTES
# on, the histogram reads every SAMPLE_EVERY-th block (for host data a miss
# costs one exact histogram and one more K1 pass; a device tensor's exact
# histogram is always taken, and no K1 pass is lost); above CHUNK_BLOCKS
# blocks (16 MiB at 1 KiB blocks) the input is staged CHUNK_BLOCKS blocks
# at a time.
SAMPLE_MIN_BYTES = 4 * 1024 * 1024
SAMPLE_EVERY = 16
CHUNK_BLOCKS = 16384


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


@dataclasses.dataclass(frozen=True)
class PlanesEncoded:
    """What encode returns for a bf16 tensor on the codec's device, and
    container.loads_device reads back from a version 4 container: the
    exponent plane's ResidentEncoded (its n_bytes the n elements), the
    (n,) uint8 sign-mantissa plane on the same device, and n."""
    exponent: ResidentEncoded
    sign_mantissa: torch.Tensor
    n: int


@dataclasses.dataclass
class EncodeTrace:
    """How one encode ran: whether its codebook came from a sample, and
    whether the exact one replaced it because the sample lacked a byte of
    the input (found by K1's flag for host data, by the exact histogram
    before K1 for a device tensor); K1's capacity (words) at each pass
    over the blocks, in order, the last one the capacity that held; and
    the chunks the input was staged in (0: one copy)."""
    sampled: bool = False
    rebuilt: bool = False
    capacities_tried: list = dataclasses.field(default_factory=list)
    chunks: int = 0


def as_u8(data) -> np.ndarray:
    """Host data (bytes or an array) as a flat uint8 array, no copy made
    where it already is one."""
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


def device_blocks(arr: np.ndarray, cfg: CodecConfig, device: torch.device):
    """(NB, block_bytes) uint8 blocks on `device`, zero past the input, and
    the (NB,) int32 valid byte counts (transfer.device_rows)."""
    return transfer.device_rows(arr, cfg.num_blocks(arr.size),
                                cfg.block_bytes, device)


def codebook_tensors(cb: Codebook, device: torch.device):
    """The kernels' (256,) int32 codes (uint32 bit patterns) and lengths."""
    if cb.max_len > 24:
        raise ValueError(f"codebook has {cb.max_len}-bit codes; at most 24")
    codes = transfer.to_device(np.ascontiguousarray(cb.codes, np.uint32)
                               .view(np.int32), device)
    return codes, transfer.to_device(np.ascontiguousarray(cb.lengths,
                                                          np.int32), device)


def codebook_for(data: torch.Tensor, n: int, cfg: CodecConfig) -> Codebook:
    """The codebook of the first n bytes of a device tensor (blocks, rows
    or a sample): its device histogram, the canonical code on the host
    with cfg.narrow_tol's cap policy (histogram_book)."""
    return histogram_book(transfer.to_host(hist_ops.histogram(data, n)), cfg)


def histogram_book(freqs: np.ndarray, cfg: CodecConfig) -> Codebook:
    """Codebook.from_frequencies_auto of a host histogram under cfg, built
    in span encode.build with the caps it priced (`caps`) and the
    codebooks it finished (`books`)."""
    done = codebooks.finished.n
    with span("encode.build") as rec:
        cb, caps = codebooks.auto_book(freqs, cfg.max_code_len,
                                       cfg.narrow_tol)
        if rec is not None:
            rec.attrs.update(caps=caps, books=codebooks.finished.n - done)
    return cb


def sample_rows(x, cfg: CodecConfig, every: int):
    """The bytes of blocks 0, every, 2 * every, ... of the 1-D host array
    or device tensor x, in order, gathered where x lies.  Only the last
    block can be partial, so these are the first valid[::every].sum()
    bytes of the sampled (zero-padded) rows."""
    bb = cfg.block_bytes
    full = len(x) // bb
    rows = x[: full * bb].reshape(full, bb)[::every].reshape(-1)
    if len(x) > full * bb and full % every == 0:
        join = torch.cat if isinstance(x, torch.Tensor) else np.concatenate
        return join([rows, x[full * bb:]])
    return rows


def build_codebook(data, cfg: CodecConfig = DEFAULT_CONFIG, device="cuda",
                   sample_every: int = 1) -> Codebook:
    """Histogram on `device` + host canonical codebook, with the
    cfg.narrow_tol cap policy of the JAX package.  With sample_every k > 1
    only every k-th block is counted (sample_rows): the codebook may then
    lack codes for bytes outside the sample, which K1 flags."""
    device = torch.device(device)
    x = _resident_u8(data) if _resident(data, device) else as_u8(data)
    if sample_every > 1:
        x = sample_rows(x, cfg, sample_every)
    if isinstance(x, np.ndarray):
        x = transfer.to_device(x, device)
    return codebook_for(x, x.numel(), cfg)


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


def capacities(cb: Codebook, cfg: CodecConfig,
               device: torch.device) -> list[int]:
    """K1's capacities (words) for codebook cb on `device`, narrowest
    first: _cap_schedule's on the kernel path, else cfg.capacity_words
    alone.  The dense and the sharded encode both run them."""
    if _kernel_path(device):
        return _cap_schedule(cfg, _kernel_mcl(cb), cb.est_bpb)
    return [cfg.capacity_words]


def empty_encoded(cfg: CodecConfig, codebook: Codebook | None,
                  device: torch.device | None = None
                  ) -> Encoded | ResidentEncoded:
    """The result of an empty input: no words, one block of 0 bits, the
    given codebook or one with no codes.  With `device`, the
    ResidentEncoded of those on it."""
    cb = codebook or Codebook.from_lengths(np.zeros(256))
    if device is None:
        return Encoded(np.zeros(0, np.uint32), 0, np.zeros(1, np.int32), cb,
                       0, cfg)
    return ResidentEncoded(torch.zeros(0, dtype=torch.int32, device=device),
                           0, torch.zeros(1, dtype=torch.int32,
                                          device=device), cb, 0, cfg)


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


def encode(data, cfg: CodecConfig = DEFAULT_CONFIG,
           codebook: Codebook | None = None,
           model: "CodebookModel | None" = None,
           device="cuda") -> Encoded | ResidentEncoded | PlanesEncoded:
    """Encode a byte stream on `device`.

    The codebook comes from, in this order: `codebook`, then
    `model.codebook_for(data)` (models.CodebookModel; FixedCodebook skips
    the histogram), then the per-stream build (sampled on the kernel
    path, rebuilt exactly on a miss).  A given or modelled codebook that
    lacks a code for some input byte raises ValueError.  A uint8 tensor on
    `device` is encoded where it lies, into a ResidentEncoded; a bf16
    tensor there into a PlanesEncoded, the codebook (given, modelled or
    built) that of its exponent plane; any other data is host data,
    encoded into an Encoded."""
    return encode_traced(data, cfg, codebook, model, device)[0]


def encode_traced(data, cfg: CodecConfig = DEFAULT_CONFIG,
                  codebook: Codebook | None = None,
                  model: "CodebookModel | None" = None,
                  device="cuda") -> tuple[Encoded | ResidentEncoded
                                          | PlanesEncoded, EncodeTrace]:
    """encode, and how it ran (EncodeTrace).  Its stages run in spans
    (utils/timing.py) under a root "encode": encode.sample,
    encode.codebook, encode.upload, one encode.pass a pass over the blocks
    (its children one encode.stage a staged chunk and encode.bits),
    encode.rebuild, encode.pack and encode.stream (the stream words and
    the bit counts down).  A codebook built from a histogram is built on
    the host in encode.build (histogram_book), inside encode.codebook or
    encode.rebuild.  Of a tensor on `device` the root carries
    resident=True, and the stages are encode.pad (only where the input
    ends inside a block), encode.sample (gathered on the device),
    encode.codebook (with exact=True or False where a sample was taken:
    whether the exact histogram chose the codebook), encode.pass (with
    encode.bits) and encode.pack.  Of a bf16 tensor the root also carries
    planes=True and its bytes are the tensor's, and encode.split
    (elements, plane_bytes) comes first."""
    device = torch.device(device)
    trace = EncodeTrace()
    if _resident(data, device) and data.dtype == torch.bfloat16:
        return _encode_planes(data.reshape(-1), cfg, codebook, model,
                              trace), trace
    resident = _resident(data, device)
    data = _resident_u8(data) if resident else as_u8(data)
    device = data.device if resident else device
    n = len(data)
    if n == 0:
        return empty_encoded(cfg, codebook, device if resident else None), \
            trace
    attrs = {"resident": True} if resident else {}
    with span("encode", format="dense", bytes=n, **attrs):
        stream, bits, total, cb = _encode_core(data, n, cfg, codebook, model,
                                               device, trace)
        if resident:
            return ResidentEncoded(stream, total, bits, cb, n, cfg), trace
        with span("encode.stream"):
            words = transfer.to_host(stream).view(np.uint32)
            block_bits = transfer.to_host(bits)
    return Encoded(words, total, block_bits, cb, n, cfg), trace


def _encode_planes(x: torch.Tensor, cfg: CodecConfig,
                   codebook: Codebook | None, model,
                   trace: EncodeTrace) -> PlanesEncoded:
    """The 1-D bf16 tensor x split into its planes (span encode.split), the
    exponent plane encoded by _encode_core as a uint8 tensor is."""
    n, device = x.numel(), x.device
    if n == 0:
        return PlanesEncoded(empty_encoded(cfg, codebook, device),
                             torch.zeros(0, dtype=torch.uint8, device=device),
                             0)
    with span("encode", format="dense", bytes=2 * n, resident=True,
              planes=True):
        with span("encode.split", elements=n, plane_bytes=n):
            exponent, sign_mantissa = k_planes.split_bf16(x)
        stream, bits, total, cb = _encode_core(exponent, n, cfg, codebook,
                                               model, device, trace)
    return PlanesEncoded(ResidentEncoded(stream, total, bits, cb, n, cfg),
                         sign_mantissa, n)


def _encode_core(data, n: int, cfg: CodecConfig, codebook: Codebook | None,
                 model, device: torch.device, trace: EncodeTrace):
    """The dense encode of data's n bytes: the blocks on `device` (a
    tensor's rows where they lie, before the first codebook; host data's
    uploaded after it, _upload); the first codebook (_first_book); the
    exact codebook where none came first; K1's passes (_k1_passes); the
    scan and pack (_pack).  Returns the stream words and the int32 bit
    counts, both on the device, the total bits and the final codebook."""
    if isinstance(data, torch.Tensor):
        blocks, first_pass = resident_blocks(data, cfg), None
        valid = transfer.valid_on(n, blocks.shape[0], cfg.block_bytes,
                                  device)
        cb = _first_book(data, n, cfg, codebook, model, device, trace,
                         blocks)
        rebuild = False
    else:
        cb = _first_book(data, n, cfg, codebook, model, device, trace)
        blocks, valid, first_pass = _upload(data, cb, cfg, device, trace)
        rebuild = trace.sampled
    if cb is None:
        with span("encode.codebook"):
            cb = codebook_for(blocks, n, cfg)
    cb, streams, bits_raw, counts = _k1_passes(cb, blocks, valid, n, cfg,
                                               trace, first_pass, rebuild)
    stream, bits = _pack(streams, bits_raw, counts, cfg)
    return stream, bits, counts.total, cb


def _first_book(data, n: int, cfg: CodecConfig, codebook: Codebook | None,
                model, device: torch.device, trace: EncodeTrace,
                blocks: torch.Tensor | None = None) -> Codebook | None:
    """The codebook before K1 runs: the given one, the model's, or on the
    kernel path from SAMPLE_MIN_BYTES on the sample's (trace.sampled):
    every SAMPLE_EVERY-th block of data's n bytes, gathered where data
    lies and, from the host, copied up.  None where the exact book is to
    be built from the blocks.

    With `blocks` (a device tensor's, already placed) the sample's
    histogram and the exact one of the blocks' n bytes come down in one
    copy, and one codebook is built: the sample's where it counts every
    byte that the exact histogram counts, else the exact one
    (trace.rebuilt).  Its codes are exactly the bytes its histogram
    counts, so K1 flags no byte under it, and the codebook is the one
    that K1's flag and a rebuild would have ended with."""
    if codebook is None and model is not None:
        with span("encode.codebook"):
            codebook = model.codebook_for(data)
    trace.sampled = (_kernel_path(device) and codebook is None
                     and n >= SAMPLE_MIN_BYTES)
    if not trace.sampled:
        return codebook
    with span("encode.sample"):
        sample = sample_rows(data, cfg, SAMPLE_EVERY)
    with span("encode.codebook") as rec:
        if isinstance(sample, np.ndarray):
            sample = transfer.to_device(sample, device)
        if blocks is None:
            return codebook_for(sample, sample.numel(), cfg)
        freqs = transfer.to_host(torch.stack([
            hist_ops.histogram(sample), hist_ops.histogram(blocks, n)]))
        trace.rebuilt = bool(((freqs[1] > 0) & (freqs[0] == 0)).any())
        if rec is not None:
            rec.attrs["exact"] = trace.rebuilt
        return histogram_book(freqs[int(trace.rebuilt)], cfg)


def _upload(arr: np.ndarray, cb: Codebook | None, cfg: CodecConfig,
            device: torch.device, trace: EncodeTrace):
    """Host data's (NB, block_bytes) blocks and valid counts on `device`
    (span encode.upload), and the first K1 pass where the input is staged,
    else None.  It is staged above CHUNK_BLOCKS blocks on the kernel path
    once a codebook exists (an exact one is built from the whole input on
    the device): the first pass runs K1 on each chunk of CHUNK_BLOCKS
    blocks as transfer.stage_chunks lands it, each chunk writing its rows
    of one (NB, cap) output, and counts the chunks in trace.chunks.
    Smaller inputs go up in one copy."""
    n, nb, bb = arr.size, cfg.num_blocks(arr.size), cfg.block_bytes
    with span("encode.upload"):
        if not (_kernel_path(device) and cb is not None
                and nb > CHUNK_BLOCKS):
            return (*device_blocks(arr, cfg, device), None)
        rows = torch.empty(nb * bb, dtype=torch.uint8, device=device)
        valid = transfer.valid_on(n, nb, bb, device)
    blocks = rows.view(nb, bb)

    def staged_pass(codes, lengths, cap):
        streams = torch.empty((nb, cap), dtype=torch.int32, device=device)
        bits = torch.empty(nb, dtype=torch.int32, device=device)
        for lo, hi in transfer.stage_chunks(arr, rows, CHUNK_BLOCKS * bb):
            b0, b1 = lo // bb, hi // bb
            k_encode.encode_blocks(blocks[b0:b1], codes, lengths,
                                   valid[b0:b1], cap,
                                   out=(streams[b0:b1], bits[b0:b1]))
            trace.chunks += 1
        return streams, bits
    return blocks, valid, staged_pass


class PassCounts(NamedTuple):
    """What the driver reads of a K1 pass's per-block bit counts: whether a
    valid byte had no code (MISS_FLAG), and else the largest count and the
    total."""
    flagged: bool
    top: int
    total: int


def pass_counts(bits_raw: torch.Tensor) -> PassCounts:
    """A pass's counts reduced on their device: the flag, the largest
    count and the total cross, 24 bytes, and the counts stay."""
    bits = bits_raw & BITS_MASK
    summary = torch.stack([(bits_raw < 0).any().to(torch.int64),
                           bits.max().to(torch.int64),
                           bits.sum(dtype=torch.int64)])
    flagged, top, total = (int(v) for v in transfer.to_host(summary))
    return PassCounts(bool(flagged), top, total)


def _k1_passes(cb: Codebook, blocks: torch.Tensor, valid: torch.Tensor,
               n: int, cfg: CodecConfig, trace: EncodeTrace,
               first_pass=None, rebuild: bool = False):
    """K1 at each of capacities() until one holds every block.  With
    `rebuild` (host data's sampled book) a byte without a code rebuilds
    the book from the exact histogram of the resident blocks, once
    (trace.rebuilt), and K1 runs again; under any other book it raises
    ValueError.  first_pass(codes, lengths, cap), where given, makes the
    first pass (the staged one).  Returns the final book, K1's streams and
    raw bit counts on the device, and the last pass's PassCounts."""
    device = blocks.device
    while True:
        codes, lengths = codebook_tensors(cb, device)
        sched = capacities(cb, cfg, device)
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
                    counts = pass_counts(bits_raw)
                missed = rebuild and counts.flagged
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
            cb = codebook_for(blocks, n, cfg)
        rebuild, trace.rebuilt = False, True


def _pack(streams: torch.Tensor, bits_raw: torch.Tensor,
          counts: PassCounts, cfg: CodecConfig):
    """check_overflow (the counts come down only for a block past the
    capacity, to name it), then the offset scan and pack at the capacity
    that held (_scan_pack).  Returns the stream words and the int32 bit
    counts on the device."""
    with span("encode.pack"):
        bits = bits_raw & BITS_MASK
        if cfg.check_overflow and counts.top > cfg.capacity_words * 32:
            check_overflow(transfer.to_host(bits), cfg)
        return _scan_pack(streams, bits, cdiv(counts.total, 32)), bits


def _scan_pack(streams: torch.Tensor, bits: torch.Tensor,
               n_words: int | None = None) -> torch.Tensor:
    """The int64 offset scan of the int32 bit counts and pack of K1's
    streams into n_words stream words; without n_words the scan's total
    is read, one host sync."""
    offsets = exclusive_bit_offsets(bits)
    if n_words is None:
        n_words = int(transfer.to_host(offsets.total_words))
    return k_pack.pack_blocks(streams, bits, offsets.word_base,
                              offsets.bit_shift, n_words)


def encode_pipeline(blocks: torch.Tensor, codes: torch.Tensor,
                    lengths: torch.Tensor, valid: torch.Tensor,
                    capacity_words: int):
    """The device part of encode on device-resident inputs: K1 -> offset
    scan -> pack (_scan_pack), with no checks.  Returns (stream words, raw
    block bits) on the blocks' device; reading the stream's length is one
    host sync."""
    streams, bits_raw = k_encode.encode_blocks(blocks, codes, lengths, valid,
                                               capacity_words)
    return _scan_pack(streams, bits_raw & BITS_MASK), bits_raw


def _decode_blocks(stream_words, word_base: torch.Tensor,
                   bit_shift: torch.Tensor, valid: torch.Tensor,
                   cb: Codebook, block_bytes: int) -> torch.Tensor:
    """K4 over the blocks; stream_words a host array of uint32 words, which
    goes up, or an int32 tensor on the device already."""
    device = word_base.device
    tb = max(cb.max_len, 1)
    with span("decode.upload"):
        table = transfer.to_device(table_entries(cb, tb), device)
        stream = (stream_words if isinstance(stream_words, torch.Tensor)
                  else transfer.to_device(
                      np.ascontiguousarray(stream_words, np.uint32)
                      .view(np.int32), device))
    with span("decode.kernel"):
        return k_decode.decode_blocks(stream, word_base, bit_shift, valid,
                                      table, tb, block_bytes)


def decode(enc: Encoded | ResidentEncoded | PlanesEncoded, device="cuda"):
    """Decode every block.  An Encoded decodes on `device`, its bit counts
    and stream words copied up, into a host uint8 array; a
    ResidentEncoded on its tensors' device, into a uint8 tensor there; a
    PlanesEncoded likewise, its exponents then merged with its
    sign-mantissa plane into a bf16 tensor there.  The offsets and the
    valid counts are made on the device.  Its stages run in spans under a
    root "decode" (resident=True for a ResidentEncoded, and planes=True,
    its bytes the tensor's, for a PlanesEncoded): decode.offsets (the bit
    counts up and the device scan), decode.upload (the stream words and
    the table), decode.kernel, decode.merge for a PlanesEncoded and, for
    an Encoded, decode.output (the bytes down)."""
    if isinstance(enc, PlanesEncoded):
        return _decode_planes(enc)
    resident = isinstance(enc, ResidentEncoded)
    device = enc.stream_words.device if resident else torch.device(device)
    if enc.n_bytes == 0:
        return (torch.zeros(0, dtype=torch.uint8, device=device) if resident
                else np.zeros(0, np.uint8))
    attrs = {"resident": True} if resident else {}
    with span("decode", format="dense", bytes=enc.n_bytes, **attrs):
        out = _decode_stream(enc, device)
        if resident:
            return out
        with span("decode.output"):
            return transfer.to_host(out)


def _decode_planes(enc: PlanesEncoded) -> torch.Tensor:
    device = enc.sign_mantissa.device
    if enc.n == 0:
        return torch.zeros(0, dtype=torch.bfloat16, device=device)
    with span("decode", format="dense", bytes=2 * enc.n, resident=True,
              planes=True):
        exponent = _decode_stream(enc.exponent, device)
        with span("decode.merge"):
            return k_planes.merge_bf16(exponent, enc.sign_mantissa)


def _decode_stream(enc: Encoded | ResidentEncoded,
                   device: torch.device) -> torch.Tensor:
    """K4 over every block of enc on `device`: its n_bytes as a uint8
    tensor there (spans decode.offsets, decode.upload, decode.kernel)."""
    bb = enc.config.block_bytes
    with span("decode.offsets"):
        bits = (enc.block_bits if isinstance(enc, ResidentEncoded)
                else transfer.to_device(
                    np.ascontiguousarray(enc.block_bits, np.int32), device))
        offsets = exclusive_bit_offsets(bits)
        valid = transfer.valid_on(enc.n_bytes, bits.numel(), bb, device)
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
        word_base = transfer.to_device(word_base[b0:b1] - w0, device)
        bit_shift = transfer.to_device((starts[b0:b1] & 31).astype(np.int32),
                                       device)
        valid = transfer.valid_on(enc.n_bytes - b0 * bb, b1 - b0, bb, device)
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
            return transfer.to_host(
                out.reshape(-1)[start - b0 * bb: stop - b0 * bb])


def roundtrip_ok(data, cfg: CodecConfig = DEFAULT_CONFIG,
                 device="cuda") -> bool:
    """Encode + decode on `device` and compare with the input."""
    arr = as_u8(data)
    return bool(np.array_equal(decode(encode(arr, cfg, device=device),
                                      device=device), arr))
