"""Host milliseconds of the payload words' bytes in container out, the v1
big-endian swap or the v3 word copy (the program's spans container.words
under container.dumps), per GiB of input."""

from bench_torch.metrics._spans import ms_per_gib


def read(run):
    return ms_per_gib(run, "container.dumps", "container.words")
