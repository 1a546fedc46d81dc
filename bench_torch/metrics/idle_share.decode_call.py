"""Percent of the program's decode calls' wall (its root spans "decode") in
which the cell's cards run no kernel, memcpy or memset, averaged over the
cards: idle_share.decode without the container stage."""

from bench_torch.metrics._spans import idle_share


def read(run):
    return idle_share(run, "decode")
