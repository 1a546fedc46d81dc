"""Host milliseconds of the payload CRC-32 in container out (the program's
spans container.crc under container.dumps) per GiB of input."""

from bench_torch.metrics._spans import ms_per_gib


def read(run):
    return ms_per_gib(run, "container.dumps", "container.crc")
