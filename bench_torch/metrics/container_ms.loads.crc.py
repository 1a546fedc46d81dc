"""Host milliseconds of the payload CRC-32 check in container in, the payload
slice included (the program's spans container.crc under container.loads),
per GiB of input."""

from bench_torch.metrics._spans import ms_per_gib


def read(run):
    return ms_per_gib(run, "container.loads", "container.crc")
