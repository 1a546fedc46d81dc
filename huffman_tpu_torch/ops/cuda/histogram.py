"""Wrapper of the CUDA byte histogram (csrc/histogram.cu), in place of the
JAX package's device histogram (huffman_tpu/ops/histogram.py
histogram_onehot, an XLA nibble one-hot contraction; no Pallas kernel)."""

from __future__ import annotations

import torch

from .. import Counter
from .. import histogram as plain
from . import _build

SOURCE = "huffman_tpu_torch/csrc/histogram.cu"
REPLACES = "huffman_tpu/ops/histogram.py:40"
launches = Counter()


def histogram(data: torch.Tensor, n: int) -> torch.Tensor:
    """ops.histogram.histogram_plain on the card: the int64 (256,) count of
    data[:n], data a contiguous 1-D uint8 tensor at any address and
    0 <= n <= data.numel()."""
    if data.device.type == "cpu":
        return plain.histogram_plain(data, n)
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"histogram: unsupported device {dev}")
    _build.require(data, "data", torch.uint8, (data.numel(),), dev)
    if not 0 <= n <= data.numel():
        raise ValueError(f"histogram: n = {n} outside [0, {data.numel()}]")
    out = torch.zeros(plain.NUM_SYMBOLS, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(dev):          # the launch uses the current device
        err = lib.huff_histogram(data.data_ptr(), n, out.data_ptr(),
                                 _build.stream_ptr(dev))
    _build.check(err, "histogram")
    launches.n += 1
    return out
