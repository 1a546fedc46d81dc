"""Host milliseconds of the dense driver's sample gather (the program's spans
encode.sample, api.sample_rows) per GiB of input encoded."""

from bench_torch.metrics._spans import ms_per_gib


def read(run):
    return ms_per_gib(run, "encode", "encode.sample")
