"""DFloat11's planes of bf16 weights on card-resident data, on one device:
the loop's uint8 card tensor viewed as bf16 words, api.encode_traced of
that tensor (a PlanesEncoded) + container.dumps_device (version 4),
container.loads_device + api.decode, whose bf16 output is handed back as
its bytes.  A program without the planes entry points fails here, at
construction."""

from __future__ import annotations

import torch

from .._codec import codec_config


class System:
    def __init__(self, config: dict, chips: int, device: str):
        from huffman_tpu_torch import api, container
        missing = [name for mod, name in ((api, "PlanesEncoded"),
                                          (container, "dumps_device"),
                                          (container, "loads_device"))
                   if not hasattr(mod, name)]
        if missing:
            raise RuntimeError(f"the program has no bf16 planes entry "
                               f"points: {', '.join(missing)} missing")
        self.api, self.container = api, container
        self.cfg = codec_config(config)
        self.devices = [torch.device(device, 0) if device == "cuda"
                        else torch.device(device)]

    def encode(self, x):
        enc, trace = self.api.encode_traced(x.view(torch.bfloat16), self.cfg,
                                            device=self.devices[0])
        return enc, {"sampled": trace.sampled, "rebuilt": trace.rebuilt,
                     "capacities_tried": list(trace.capacities_tried),
                     "chunks": trace.chunks}

    def dumps(self, enc) -> torch.Tensor:
        return self.container.dumps_device(enc)

    def loads(self, buf: torch.Tensor):
        return self.container.loads_device(buf)

    def decode(self, enc) -> torch.Tensor:
        return self.api.decode(enc, device=self.devices[0]).view(torch.uint8)
