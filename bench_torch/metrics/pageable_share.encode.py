"""Percent of the bytes that the program's encode calls copy between host
and device through pageable host memory (the rest through pinned), from
the counts the root spans "encode" carry."""

from bench_torch.metrics._spans import pageable_share


def read(run):
    return pageable_share(run, "encode")
