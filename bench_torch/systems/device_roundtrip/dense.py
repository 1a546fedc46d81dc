"""The dense codec on card-resident data, on one device: api.encode_traced
of a tensor + container.dumps_device, container.loads_device +
api.decode.  A program without the device entry points fails here, at
construction."""

from __future__ import annotations

import torch

from .._codec import codec_config


class System:
    def __init__(self, config: dict, chips: int, device: str):
        from huffman_tpu_torch import api, container
        missing = [name for mod, name in ((api, "ResidentEncoded"),
                                          (container, "dumps_device"),
                                          (container, "loads_device"))
                   if not hasattr(mod, name)]
        if missing:
            raise RuntimeError(f"the program has no card-resident entry "
                               f"points: {', '.join(missing)} missing")
        self.api, self.container = api, container
        self.cfg = codec_config(config)
        self.devices = [torch.device(device, 0) if device == "cuda"
                        else torch.device(device)]

    def encode(self, x):
        enc, trace = self.api.encode_traced(x, self.cfg,
                                            device=self.devices[0])
        return enc, {"sampled": trace.sampled, "rebuilt": trace.rebuilt,
                     "capacities_tried": list(trace.capacities_tried),
                     "chunks": trace.chunks}

    def dumps(self, enc) -> torch.Tensor:
        return self.container.dumps_device(enc)

    def loads(self, buf: torch.Tensor):
        return self.container.loads_device(buf)

    def decode(self, enc) -> torch.Tensor:
        return self.api.decode(enc, device=self.devices[0])
