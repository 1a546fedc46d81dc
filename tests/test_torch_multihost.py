"""The port's sharded codec across two processes, on CPU.

Two processes join one gloo process group (parallel.mesh.init_multihost)
with two CPU shards each, so the global mesh has four shards.  Each holds
the whole input, uploads only its own shards, and must end with the full
result: the dense stream equal to the golden encoder's and to the port's
single-device encode, the wide container equal to the single-device one,
and both roundtrips equal to the input.

The worker is this file run as a script, which imports neither jax nor
conftest.py:
    python tests/test_torch_multihost.py <rank> <world> <port>
It prints MULTIPROCESS-OK on success.
"""

import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OK = "MULTIPROCESS-OK"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_equal_single_device(tmp_path):
    port = _free_port()
    logs = [open(tmp_path / f"worker{rank}.log", "w+") for rank in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), "2",
         str(port)], stdout=log, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT) for rank, log in enumerate(logs)]
    t0 = time.monotonic()
    try:
        # a worker that fails leaves the other waiting in a collective:
        # stop both at the first failure, or at the time limit
        while any(p.poll() is None for p in procs):
            if any(p.poll() for p in procs) or time.monotonic() - t0 > 240:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out[-3000:]}"
        assert OK in out, f"worker {rank} printed no OK:\n{out[-3000:]}"


def _worker(rank: int, world: int, port: int) -> None:
    sys.path.insert(0, ROOT)
    import numpy as np

    from huffman_tpu_torch import api, container, golden, wide
    from huffman_tpu_torch.config import CodecConfig
    from huffman_tpu_torch.golden.numpy_codec import packed_bytes_to_words
    from huffman_tpu_torch.golden.wide_codec import TILE_BYTES
    from huffman_tpu_torch.parallel.mesh import init_multihost, make_mesh
    from huffman_tpu_torch.parallel.pipeline import ShardedCodec
    from huffman_tpu_torch.utils import testdata

    init_multihost(f"localhost:{port}", world, rank)
    mesh = make_mesh(devices=["cpu", "cpu"])
    assert mesh.size == 2 * world, mesh
    assert mesh.local_shards == [2 * rank, 2 * rank + 1], mesh

    for cfg, n in ((CodecConfig(block_bytes=64), 4 * 3 * 64 + 29),
                   (CodecConfig(), 100_000)):
        data = testdata.skewed(n, num_symbols=16, seed=7)
        codec = ShardedCodec(mesh, cfg)
        enc = codec.encode(data)
        g_bytes, g_bits = golden.encode(data, enc.codebook)
        assert enc.total_bits == g_bits
        assert np.array_equal(enc.stream_words, packed_bytes_to_words(g_bytes))
        assert container.dumps(enc) == container.dumps(
            api.encode(data, cfg, device="cpu"))
        assert np.array_equal(codec.decode(enc), data)

    data = testdata.skewed(3 * TILE_BYTES - 5000, num_symbols=32, seed=8)
    codec = ShardedCodec(mesh)
    enc = codec.encode_wide(data)
    assert container.dumps_wide(enc) == container.dumps_wide(
        wide.encode_wide(data, device="cpu"))
    assert np.array_equal(codec.decode_wide(enc), data)
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "huffman_tpu")]
    assert not bad, bad
    print(f"{OK} rank {rank}", flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
