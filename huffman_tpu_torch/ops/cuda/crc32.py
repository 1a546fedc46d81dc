"""Wrapper of the CUDA payload swap and CRC-32 (csrc/crc32.cu).  It ports
no kernel of the JAX package, which swaps and takes the CRC on the host:
it lets a card-resident stream become a v1 container in card memory and
back (container.dumps_device, container.loads_device), and copy_crc32
lets the raw plane of a version 4 container follow it, under one CRC."""

from __future__ import annotations

import torch

from .. import Counter
from .. import crc32 as plain
from . import _build

SOURCE = "huffman_tpu_torch/csrc/crc32.cu"
REPLACES = None
launches = Counter()
copy_launches = Counter()                 # copy_crc32's


def swap_crc32(src: torch.Tensor, dst: torch.Tensor, crc: torch.Tensor,
               to_payload: bool) -> torch.Tensor:
    """ops.crc32.swap_crc32_plain on the card; same arguments and result:
    src and dst contiguous (W,) int32 tensors that do not overlap, crc a
    (1,) int32 tensor, at 4-byte aligned addresses (views into a
    container are fine)."""
    if src.device.type == "cpu":
        return plain.swap_crc32_plain(src, dst, crc, to_payload)
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"swap_crc32: unsupported device {dev}")
    n = src.numel()
    _build.require(src, "src", torch.int32, (n,), dev)
    _build.require(dst, "dst", torch.int32, (n,), dev)
    _build.require(crc, "crc", torch.int32, (1,), dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):          # the launch uses the current device
        err = lib.huff_swap_crc32(src.data_ptr(), dst.data_ptr(), n,
                                  int(bool(to_payload)), crc.data_ptr(),
                                  _build.stream_ptr(dev))
    _build.check(err, "crc32")
    launches.n += 1
    return crc


def copy_crc32(src: torch.Tensor, dst: torch.Tensor | None,
               crc: torch.Tensor,
               start: torch.Tensor | None = None) -> torch.Tensor:
    """ops.crc32.copy_crc32_plain on the card; same arguments and result:
    src and dst (or None: only read) contiguous (W,) int32 tensors that do
    not overlap, crc and start (or None) (1,) int32 tensors, crc not
    start, all at 4-byte aligned addresses."""
    if start is not None and start.data_ptr() == crc.data_ptr():
        raise ValueError("copy_crc32: crc and start are one word")
    if src.device.type == "cpu":
        return plain.copy_crc32_plain(src, dst, crc, start)
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"copy_crc32: unsupported device {dev}")
    n = src.numel()
    _build.require(src, "src", torch.int32, (n,), dev)
    if dst is not None:
        _build.require(dst, "dst", torch.int32, (n,), dev)
    _build.require(crc, "crc", torch.int32, (1,), dev)
    if start is not None:
        _build.require(start, "start", torch.int32, (1,), dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):          # the launch uses the current device
        err = lib.huff_copy_crc32(
            src.data_ptr(), None if dst is None else dst.data_ptr(), n,
            None if start is None else start.data_ptr(), crc.data_ptr(),
            _build.stream_ptr(dev))
    _build.check(err, "copy_crc32")
    copy_launches.n += 1
    return crc
