"""Host milliseconds of the raw plane of a container version 4, its copy
and CRC-32 in container out and its CRC-32 in container in (the program's
spans container.plane under container.dumps and container.loads), per
GiB of input, the two added."""

from bench_torch.metrics._spans import ms_per_gib


def read(run):
    parts = [ms_per_gib(run, root, "container.plane")
             for root in ("container.dumps", "container.loads")]
    found = [p for p in parts if p is not None]
    return sum(found) if found else None
