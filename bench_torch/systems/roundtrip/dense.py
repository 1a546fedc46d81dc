"""The dense codec on one device: api.encode_traced + container.dumps,
container.loads + api.decode."""

from __future__ import annotations

import torch

from .._codec import codec_config


class System:
    def __init__(self, config: dict, chips: int, device: str):
        from huffman_tpu_torch import api, container
        self.api, self.container = api, container
        self.cfg = codec_config(config)
        self.devices = [torch.device(device, 0) if device == "cuda"
                        else torch.device(device)]

    def encode(self, arr):
        enc, trace = self.api.encode_traced(arr, self.cfg,
                                            device=self.devices[0])
        return enc, {"sampled": trace.sampled, "rebuilt": trace.rebuilt,
                     "capacities_tried": list(trace.capacities_tried),
                     "chunks": trace.chunks}

    def dumps(self, enc) -> bytes:
        return self.container.dumps(enc)

    def loads(self, blob: bytes):
        return self.container.loads(blob)

    def decode(self, enc):
        return self.api.decode(enc, device=self.devices[0])
