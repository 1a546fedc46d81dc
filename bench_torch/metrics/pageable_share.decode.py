"""Percent of the bytes that the program's decode calls copy between host
and device through pageable host memory (the rest through pinned), from
the counts the root spans "decode" carry."""

from bench_torch.metrics._spans import pageable_share


def read(run):
    return pageable_share(run, "decode")
