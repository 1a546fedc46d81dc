"""Host milliseconds of the sharded encode's seam stitching (the program's
spans encode.assemble, parallel.pipeline.assemble_dense) per GiB of input
encoded."""

from bench_torch.metrics._spans import ms_per_gib


def read(run):
    return ms_per_gib(run, "encode", "encode.assemble")
