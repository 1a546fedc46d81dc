"""The dense codec sharded over a mesh of `chips` devices in one process:
parallel.pipeline.ShardedCodec.encode + container.dumps, container.loads +
ShardedCodec.decode (what the CLI's --mesh drives).  On the CPU, as in
the tests, the mesh repeats the one CPU device."""

from __future__ import annotations

from .._codec import codec_config


class System:
    def __init__(self, config: dict, chips: int, device: str):
        from huffman_tpu_torch import container
        from huffman_tpu_torch.parallel.mesh import make_mesh
        from huffman_tpu_torch.parallel.pipeline import ShardedCodec
        self.container = container
        mesh = (make_mesh(chips) if device == "cuda"
                else make_mesh(devices=[device] * chips))
        self.codec = ShardedCodec(mesh, codec_config(config))
        self.devices = list(dict.fromkeys(mesh.devices))

    def encode(self, arr):
        return self.codec.encode(arr), {}

    def dumps(self, enc) -> bytes:
        return self.container.dumps(enc)

    def loads(self, blob: bytes):
        return self.container.loads(blob)

    def decode(self, enc):
        return self.codec.decode(enc)
