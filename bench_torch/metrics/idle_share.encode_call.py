"""Percent of the program's encode calls' wall (its root spans "encode") in
which the cell's cards run no kernel, memcpy or memset, averaged over the
cards: idle_share.encode without the container stage."""

from bench_torch.metrics._spans import idle_share


def read(run):
    return idle_share(run, "encode")
