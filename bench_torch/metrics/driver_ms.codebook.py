"""Host milliseconds of the encode's codebook builds from a histogram (the
program's span encode.build, inside encode.codebook or encode.rebuild)
per GiB of input encoded.  The histogram's copy to the host is not in
it.  A program without the span gives None."""

from bench_torch.metrics._spans import ms_per_gib


def read(run):
    return ms_per_gib(run, "encode", "encode.build")
