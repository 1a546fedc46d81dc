"""Device mesh construction and multi-process initialization
(huffman_tpu/parallel/mesh.py).

A Mesh is the 1-D data-parallel axis of the codec: shards in order, each on
one torch device, as JAX's Mesh is an array of devices.  A device may
repeat: torch has one CPU device, so ("cpu",) * 8 stands for the JAX tests'
eight virtual CPU devices, and ("cuda:0",) * 4 puts four shards on one card,
where they run one after another on its stream.

Several processes form one mesh through torch.distributed (init_multihost):
the global mesh is the concatenation of each process's local devices.
Every process holds the whole host input and uploads only its own shards
(put_global); the exchanges are CPU tensors over the process group, which
fetch and ShardedCodec run on every process alike, so that every process
ends with the same host result, as JAX's fetch does with process_allgather.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..transfer import device_rows, host_block, to_host
from ..utils.device import probe_devices


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shard s runs on devices[s] in process ranks[s].  This process is
    `rank` of `world`; another process's devices are named as that process
    named them."""
    devices: tuple[torch.device, ...]
    ranks: tuple[int, ...]
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_shards(self) -> list[int]:
        """The shards this process owns, in order."""
        return [s for s, r in enumerate(self.ranks) if r == self.rank]


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over this process's `devices` (default: every CUDA device),
    concatenated over the processes of an initialized process group, cut to
    the first `num_devices` shards.  Raises DeviceError when there is no
    CUDA device and none are given, and ValueError when more shards are
    asked for than exist."""
    local = [torch.device(d) for d in
             (probe_devices("cuda") if devices is None else devices)]
    rank, world = _world()
    if world > 1:
        names = [None] * world
        dist.all_gather_object(names, [str(d) for d in local])
        devs = [torch.device(d) for r in range(world) for d in names[r]]
        ranks = [r for r in range(world) for _ in names[r]]
    else:
        devs, ranks = local, [0] * len(local)
    if num_devices is not None:
        if num_devices > len(devs):
            raise ValueError(
                f"requested {num_devices} devices, have {len(devs)}")
        devs, ranks = devs[:num_devices], ranks[:num_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devs), tuple(ranks), rank, world)


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """Join the gloo process group of a multi-process mesh.  The address is
    "host:port" of process 0; without arguments, torch's env:// variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) give them."""
    dist.init_process_group(
        "gloo", init_method=(f"tcp://{coordinator_address}"
                             if coordinator_address else "env://"),
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)


def pad_blocks_for_mesh(num_blocks: int, mesh: Mesh) -> int:
    """Blocks after padding to a multiple of the mesh size."""
    n = mesh.size
    return -(-num_blocks // n) * n


def put_global(arr: np.ndarray, n_rows: int, row_bytes: int, mesh: Mesh):
    """Upload a host byte stream as n_rows rows of row_bytes, zero past its
    end, split evenly over the mesh (n_rows is a multiple of its size).
    This process uploads only the shards it owns, each straight from its
    slice of `arr` (transfer.device_rows: no padded copy on the host).
    Returns per shard the (rows, valid byte counts) on its device, or
    (None, None) for another process's shard."""
    k = n_rows // mesh.size
    rows, valid = [None] * mesh.size, [None] * mesh.size
    for s in mesh.local_shards:
        part = arr[s * k * row_bytes: (s + 1) * k * row_bytes]
        rows[s], valid[s] = device_rows(part, k, row_bytes, mesh.devices[s])
    return rows, valid


def _allgather_bytes(buf: np.ndarray, world: int) -> list[np.ndarray]:
    """Every process's uint8 buffer, over gloo: all_gather needs equal
    sizes, so each buffer is padded to the largest, and the sizes travel
    beside them."""
    size = torch.tensor([buf.size], dtype=torch.int64)
    sizes = [torch.zeros_like(size) for _ in range(world)]
    dist.all_gather(sizes, size)
    m = max(int(t) for t in sizes)
    mine = torch.zeros(m, dtype=torch.uint8)
    mine[: buf.size] = torch.from_numpy(buf)
    outs = [torch.empty(m, dtype=torch.uint8) for _ in range(world)]
    dist.all_gather(outs, mine)
    return [o[: int(t)].numpy() for o, t in zip(outs, sizes)]


def fetch(mesh: Mesh, parts) -> tuple[np.ndarray, np.ndarray]:
    """Every shard's 1-D tensor, concatenated in shard order into one host
    array, and the (size + 1,) int64 offsets of the shards in it.  parts[s]
    is shard s's tensor where this process owns shard s (anything
    elsewhere); each is copied from its device straight into its place:
    into a block of transfer.host_pool where the parts are on CUDA devices
    and the whole reaches transfer.PINNED_MIN_BYTES (transfer.host_block),
    else into fresh memory.  With several processes, each process's shards
    (consecutive in the mesh) are all-gathered over the process group, so
    every process gets the whole array."""
    local = mesh.local_shards
    sizes = np.zeros(mesh.size, np.int64)
    for s in local:
        sizes[s] = parts[s].numel()
    dtype = (str(torch.empty(0, dtype=parts[local[0]].dtype).numpy().dtype)
             if local else None)
    if mesh.world > 1:
        metas = [None] * mesh.world
        dist.all_gather_object(
            metas, ([(s, int(sizes[s])) for s in local], dtype))
        for shard_sizes, dt in metas:
            for s, n in shard_sizes:
                sizes[s] = n
            dtype = dtype or dt
    offs = np.concatenate([[0], np.cumsum(sizes)])
    pooled = (host_block(parts[local[0]].dtype, (int(offs[-1]),),
                         parts[local[0]].device) if local else None)
    flat = np.empty(int(offs[-1]), dtype) if pooled is None else pooled[1]
    for s in local:
        to_host(parts[s].reshape(-1), out=flat[offs[s]: offs[s + 1]])
    if mesh.world > 1:
        def span(shards):
            return (slice(int(offs[shards[0]]), int(offs[shards[-1] + 1]))
                    if shards else slice(0, 0))
        blobs = _allgather_bytes(flat[span(local)].view(np.uint8), mesh.world)
        for r, blob in enumerate(blobs):
            if r != mesh.rank:
                mine = [s for s, o in enumerate(mesh.ranks) if o == r]
                flat[span(mine)] = blob.view(dtype)
    return flat, offs


def allreduce_sum(x: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Sum of an int64 host array over the processes of the mesh."""
    if mesh.world == 1:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x, np.int64))
    dist.all_reduce(t)
    return t.numpy()
