"""Host milliseconds of the payload words in container in, the v1 swap to host
order or the v3 word copy (the program's spans container.words under
container.loads), per GiB of input."""

from bench_torch.metrics._spans import ms_per_gib


def read(run):
    return ms_per_gib(run, "container.loads", "container.words")
