"""The wide codec on one device: wide.encode_wide + container.dumps_wide,
container.loads_wide + wide.decode_wide."""

from __future__ import annotations

import torch

from .._codec import codec_config


class System:
    def __init__(self, config: dict, chips: int, device: str):
        from huffman_tpu_torch import container, wide
        self.wide, self.container = wide, container
        self.cfg = codec_config(config)
        self.devices = [torch.device(device, 0) if device == "cuda"
                        else torch.device(device)]

    def encode(self, arr):
        return self.wide.encode_wide(arr, self.cfg,
                                     device=self.devices[0]), {}

    def dumps(self, enc) -> bytes:
        return self.container.dumps_wide(enc)

    def loads(self, blob: bytes):
        return self.container.loads_wide(blob)

    def decode(self, enc):
        return self.wide.decode_wide(enc, device=self.devices[0])
