"""Wrapper of the CUDA split and merge of bf16 byte planes
(csrc/planes.cu).  It ports no kernel of the JAX package, which codes
opaque byte streams only: it lets a bf16 tensor in card memory be coded
DFloat11's way, its exponent plane through the dense codec and its
sign-mantissa plane kept raw (api.encode, api.decode)."""

from __future__ import annotations

import torch

from .. import Counter
from .. import planes as plain
from . import _build

SOURCE = "huffman_tpu_torch/csrc/planes.cu"
REPLACES = None
launches = Counter()                      # the split's
merge_launches = Counter()


def _device(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """ops.planes.split_bf16_plain on the card: x a contiguous 1-D bf16
    tensor at any address (a view into another included); returns new
    (n,) uint8 exponent and sign-mantissa planes."""
    if x.device.type == "cpu":
        return plain.split_bf16_plain(x)
    dev, n = _device(x, "split_bf16"), x.numel()
    _build.require(x, "x", torch.bfloat16, (n,), dev)
    exponent = torch.empty(n, dtype=torch.uint8, device=dev)
    sign_mantissa = torch.empty(n, dtype=torch.uint8, device=dev)
    if n:
        lib = _build.load_library()
        with torch.cuda.device(dev):      # the launch uses the current device
            err = lib.huff_split_bf16(x.data_ptr(), exponent.data_ptr(),
                                      sign_mantissa.data_ptr(), n,
                                      _build.stream_ptr(dev))
        _build.check(err, "split_bf16")
        launches.n += 1
    return exponent, sign_mantissa


def merge_bf16(exponent: torch.Tensor,
               sign_mantissa: torch.Tensor) -> torch.Tensor:
    """ops.planes.merge_bf16_plain on the card: two contiguous (n,) uint8
    planes at any addresses (a view into a container included); returns a
    new (n,) bf16 tensor."""
    if exponent.device.type == "cpu":
        return plain.merge_bf16_plain(exponent, sign_mantissa)
    dev, n = _device(exponent, "merge_bf16"), exponent.numel()
    _build.require(exponent, "exponent", torch.uint8, (n,), dev)
    _build.require(sign_mantissa, "sign_mantissa", torch.uint8, (n,), dev)
    out = torch.empty(n, dtype=torch.bfloat16, device=dev)
    if n:
        lib = _build.load_library()
        with torch.cuda.device(dev):      # the launch uses the current device
            err = lib.huff_merge_bf16(exponent.data_ptr(),
                                      sign_mantissa.data_ptr(),
                                      out.data_ptr(), n,
                                      _build.stream_ptr(dev))
        _build.check(err, "merge_bf16")
        merge_launches.n += 1
    return out
