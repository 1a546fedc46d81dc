"""Data-parallel encode and decode over a device mesh
(huffman_tpu/parallel/pipeline.py).

Blocks (dense format) or tiles (wide format) are split evenly over the
shards of a Mesh, and every shard runs the port's CUDA kernels on its own
part: K1 and pack, or K4, for the dense format; K5, the schedule and K7, or
K8, for the wide one.  The only exchanges, on the host, are:

  * the sum of the shards' histograms, when no codebook is given (with
    several processes an all-reduce over the process group);
  * the per-block bit counts of every shard, from which each shard's bit
    base is the exclusive sum of the lower shards' totals, in int64;
  * the shards' outputs, stitched in order: dense shard streams overlap by
    one seam word whose bits are disjoint (assemble_dense); wide payloads
    are concatenated in tile order, as are tile_words and bases.

Every result equals the single-device one: ShardedCodec.encode gives
api.encode's stream words, total and (trimmed to the input's blocks)
block_bits, so the containers are byte-identical; encode_wide gives
wide.encode_wide's container, the mesh's padding tiles dropped.

The dense encode runs api.encode's capacities (api.capacities): on CUDA
devices K1 at a speculative capacity first where the codebook allows it,
again at the safe one if a block needs more.  Its histogram is exact, as
in the JAX package, which samples only on one device.

Left out against the JAX package, all Mosaic machinery whose output equals
the exact path's (ROADMAP.md): the speculative trees with their patch
overlays, the host pack plans and their buckets, and the power-of-two tile
bucketing; and encode_step, the one-shot XLA step of its multichip dry
run, which computes what the two phases here compute.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import api, transfer, wide
from ..codebook import Codebook
from ..config import DEFAULT_CONFIG, CodecConfig, cdiv
from ..golden.wide_codec import MAXLEN, N_SUB, ROUNDS, SUB_BYTES, TILE_BYTES
from ..ops import histogram as hist_ops
from ..ops.cuda import encode as k_encode
from ..ops.cuda import pack2 as k_pack
from ..ops.encode import BITS_MASK
from ..ops.scan import exclusive_bit_offsets
from ..utils.timing import span
from .mesh import Mesh, allreduce_sum, fetch, pad_blocks_for_mesh, put_global


def histogram_sharded(mesh: Mesh):
    """The global histogram as a function of the shards' (blocks, valid):
    each shard counts only its own valid bytes, which lead its rows; the
    counts are summed over the shards and the processes.  Returns a host
    (256,) int64 array."""

    def _hist(d_blocks, d_valid) -> np.ndarray:
        parts = [hist_ops.histogram(d_blocks[s],
                                    int(transfer.to_host(d_valid[s].sum())))
                 for s in mesh.local_shards]
        total = np.zeros(256, np.int64)
        for h in parts:
            total += transfer.to_host(h)
        return allreduce_sum(total, mesh)

    return _hist


def encode_phase1(mesh: Mesh, d_blocks, d_valid, cb: Codebook,
                  capacity_words: int):
    """K1 on every shard this process owns, each launched before any result
    is read.  Returns per shard the (NB_loc, cap) block streams and the raw
    bit counts (MISS_FLAG in bit 31), on the shard's device."""
    tables = {}
    streams, bits = [None] * mesh.size, [None] * mesh.size
    for s in mesh.local_shards:
        dev = mesh.devices[s]
        if dev not in tables:
            tables[dev] = api.codebook_tensors(cb, dev)
        streams[s], bits[s] = k_encode.encode_blocks(
            d_blocks[s], *tables[dev], d_valid[s], capacity_words)
    return streams, bits


def shard_bases(block_bits: np.ndarray, mesh: Mesh):
    """Each shard's bit total and first global bit (the exclusive sum of
    the lower shards' totals), int64."""
    totals = block_bits.astype(np.int64).reshape(mesh.size, -1).sum(axis=1)
    return totals, np.cumsum(totals) - totals


def pack_phase2(mesh: Mesh, streams, bits_raw, shard_bits: np.ndarray,
                shard_base: np.ndarray):
    """Pack every shard this process owns into its own slice of the dense
    stream, already at its global bit phase shift = base & 31: the block
    offsets start at bit `shift` of the shard's word 0, and the slice holds
    used = (shift + shard bits + 31) >> 5 words (0 for an empty shard at
    phase 0, 1 for a shift-only seam).  Returns the per-shard slices on the
    shards' devices and `used` for every shard."""
    shift = shard_base & 31
    used = (shift + shard_bits + 31) >> 5
    out = [None] * mesh.size
    for s in mesh.local_shards:
        bits = bits_raw[s] & BITS_MASK
        offs = exclusive_bit_offsets(bits, int(shift[s]))
        out[s] = k_pack.pack_blocks(streams[s], bits, offs.word_base,
                                    offs.bit_shift, int(used[s]))
    return out, used


def assemble_dense(shard_streams, shard_word_base: np.ndarray,
                   shard_words: np.ndarray, total_words: int) -> np.ndarray:
    """Stitch the shards' slices into the dense stream, in order.  Adjacent
    slices overlap by at most one word, the seam, whose bits are disjoint:
    each slice's words 1..used are assigned and its word 0 is ORed."""
    out = np.zeros(total_words + 1, dtype=np.uint32)
    for s, w in enumerate(shard_streams):
        base, used = int(shard_word_base[s]), int(shard_words[s])
        if used > 1:
            out[base + 1: base + used] = np.asarray(w[1:used]).view(np.uint32)
    for s, w in enumerate(shard_streams):
        if int(shard_words[s]):
            out[int(shard_word_base[s])] |= np.asarray(w[:1]).view(np.uint32)[0]
    return out[:total_words]


@dataclasses.dataclass(frozen=True)
class ShardedCodec:
    """Sharded encode and decode, in both formats, bound to a mesh and a
    config."""
    mesh: Mesh
    cfg: CodecConfig = DEFAULT_CONFIG

    def prepare(self, data) -> tuple[np.ndarray, int]:
        """The input as flat uint8 bytes and its block count, padded to a
        multiple of the mesh size (the padding is made on the devices)."""
        arr = api.as_u8(data)
        return arr, pad_blocks_for_mesh(self.cfg.num_blocks(arr.size),
                                        self.mesh)

    def shard_inputs(self, arr: np.ndarray, num_blocks: int):
        """Per shard, its (NB_loc, block_bytes) blocks and (NB_loc,) valid
        byte counts on its device (mesh.put_global)."""
        return put_global(arr, num_blocks, self.cfg.block_bytes, self.mesh)

    def _codebook(self, d_rows, d_valid) -> Codebook:
        hist = histogram_sharded(self.mesh)(d_rows, d_valid)
        return api.histogram_book(hist, self.cfg)

    def encode(self, data, codebook: Codebook | None = None) -> api.Encoded:
        """Sharded dense encode, equal to api.encode's result.

        Phase 1 runs K1 on every shard; one host copy per shard then brings
        back the bit counts, for the miss and overflow checks, the shard
        bases and the total.  Phase 1 runs at each of api.capacities until
        one holds every block, the decision the same in every process,
        which all hold every count.
        Phase 2 packs each shard at its global bit phase, and
        assemble_dense ORs one seam word per boundary.  A given codebook
        that lacks a code for some input byte raises ValueError.  The
        stages run in spans under a root "encode": encode.upload,
        encode.codebook, one encode.pass a capacity (phase 1 and the bit
        counts' fetch), encode.bases, encode.pack (phase 2), encode.stream
        (the slices' fetch) and encode.assemble.
        """
        cfg = self.cfg
        arr, nb = self.prepare(data)
        n = arr.size
        if n == 0:
            return api.empty_encoded(cfg, codebook)
        with span("encode", format="dense", bytes=n, shards=self.mesh.size):
            return self._encode(arr, nb, codebook)

    def _encode(self, arr: np.ndarray, nb: int,
                codebook: Codebook | None) -> api.Encoded:
        cfg, mesh, n = self.cfg, self.mesh, arr.size
        with span("encode.upload"):
            d_blocks, d_valid = self.shard_inputs(arr, nb)
        if codebook is None:
            with span("encode.codebook"):
                codebook = self._codebook(d_blocks, d_valid)
        cb = codebook
        sched = api.capacities(cb, cfg, mesh.devices[0])
        for cap in sched:
            with span("encode.pass", cap=cap):
                streams, bits_raw = encode_phase1(mesh, d_blocks, d_valid,
                                                  cb, cap)
                block_bits = api.block_bits_of(fetch(mesh, bits_raw)[0])
            if int(block_bits.max()) <= cap * 32 or cap == sched[-1]:
                break
        with span("encode.bases"):
            api.check_overflow(block_bits, cfg)
            shard_bits, shard_base = shard_bases(block_bits, mesh)
            total_bits = int(shard_bits.sum())
        with span("encode.pack"):
            slices, used = pack_phase2(mesh, streams, bits_raw, shard_bits,
                                       shard_base)
        with span("encode.stream"):
            flat, offs = fetch(mesh, slices)
        with span("encode.assemble"):
            stream = assemble_dense([flat[offs[s]: offs[s + 1]]
                                     for s in range(mesh.size)],
                                    shard_base >> 5, used,
                                    cdiv(total_bits, 32))
        return api.Encoded(stream_words=stream, total_bits=total_bits,
                           block_bits=block_bits[: cfg.num_blocks(n)],
                           codebook=cb, n_bytes=n, config=cfg)

    def decode(self, enc: api.Encoded) -> np.ndarray:
        """Sharded dense decode: each shard runs K4 over its own blocks,
        with only the span of the stream that covers them
        (api.decode_block_span); the shards' bytes land in order in one
        host array (mesh.fetch).  Spans: under a root "decode", one
        decode.shard a shard (decode_block_span's spans under it) and
        decode.output (the fetch)."""
        if enc.n_bytes == 0:
            return np.zeros(0, np.uint8)
        nb = len(enc.block_bits)
        k = cdiv(nb, self.mesh.size)
        with span("decode", format="dense", bytes=enc.n_bytes,
                  shards=self.mesh.size):
            outs = [None] * self.mesh.size
            for s in self.mesh.local_shards:
                b0, b1 = s * k, min(nb, (s + 1) * k)
                dev = self.mesh.devices[s]
                with span("decode.shard", shard=s, device=str(dev)):
                    outs[s] = (api.decode_block_span(enc, b0, b1, dev)
                               .reshape(-1) if b0 < b1
                               else torch.zeros(0, dtype=torch.uint8))
            with span("decode.output"):
                return fetch(self.mesh, outs)[0][: enc.n_bytes]

    def encode_wide(self, data,
                    codebook: Codebook | None = None) -> wide.WideEncoded:
        """Sharded wide encode, equal to wide.encode_wide's result.

        Tiles are independent once the codebook exists, so the split is by
        tiles: the tile count is padded to a multiple of the mesh size and
        each shard runs wide.encode_substreams (K5, schedule, K7) on its
        tile rows.  Padding tiles hold no bytes, so they schedule no pulls
        and no payload; they are dropped.  Spans: under a root "encode",
        encode.upload, encode.codebook, one encode.shard a shard
        (encode_substreams' spans under it) and encode.stream."""
        cfg = self.cfg
        if cfg.max_code_len > MAXLEN:
            raise ValueError("wide format requires max_code_len <= 12")
        arr = api.as_u8(data)
        n = arr.size
        with span("encode", format="wide", bytes=n, shards=self.mesh.size):
            return self._encode_wide(arr, codebook)

    def _encode_wide(self, arr: np.ndarray,
                     codebook: Codebook | None) -> wide.WideEncoded:
        cfg, mesh, n = self.cfg, self.mesh, arr.size
        nt = wide.num_tiles(n)
        k = pad_blocks_for_mesh(nt, mesh) // mesh.size
        with span("encode.upload"):
            d_rows, d_valid = put_global(arr, k * mesh.size * N_SUB,
                                         SUB_BYTES, mesh)
        if codebook is None:
            with span("encode.codebook"):
                codebook = self._codebook(d_rows, d_valid)
        cb = codebook
        if cb.max_len > MAXLEN:
            raise ValueError(f"codebook has {cb.max_len}-bit codes; the wide "
                             f"format takes at most {MAXLEN}")
        parts = {}
        for s in mesh.local_shards:
            with span("encode.shard", shard=s, device=str(mesh.devices[s])):
                parts[s] = wide.encode_substreams(
                    d_rows[s], d_valid[s], cb,
                    int(np.clip(n - s * k * TILE_BYTES, 0, k * TILE_BYTES)))
        with span("encode.stream"):
            payload, tile_words, bases = (
                fetch(mesh, {s: p[i] for s, p in parts.items()})[0]
                for i in range(3))
        bases = bases.reshape(-1, ROUNDS)
        if tile_words[nt:].any() or bases[nt:].any():
            raise RuntimeError("a padding tile scheduled pulls")
        return wide.WideEncoded(payload.view(np.uint32), tile_words[:nt],
                                bases[:nt], cb, n, cfg)

    def decode_wide(self, enc: wide.WideEncoded) -> np.ndarray:
        """Sharded wide decode: each shard runs K8 over its own tiles, with
        only their payload span (wide._decode_tiles); fewer tiles than
        shards leave the last shards idle.  Spans as decode's."""
        if enc.n_bytes == 0:
            return np.zeros(0, np.uint8)
        nt = len(enc.tile_words)
        k = cdiv(nt, self.mesh.size)
        with span("decode", format="wide", bytes=enc.n_bytes,
                  shards=self.mesh.size):
            outs = [None] * self.mesh.size
            for s in self.mesh.local_shards:
                t0, t1 = s * k, min(nt, (s + 1) * k)
                dev = self.mesh.devices[s]
                with span("decode.shard", shard=s, device=str(dev)):
                    outs[s] = (wide._decode_tiles(enc, t0, t1, dev)
                               .reshape(-1) if t0 < t1
                               else torch.zeros(0, dtype=torch.uint8))
            with span("decode.output"):
                return fetch(self.mesh, outs)[0][: enc.n_bytes]
