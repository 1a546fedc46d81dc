"""Percent of the bytes that the program's decode calls asked its pool of
pinned host blocks for (the root spans "decode" carry them in
`host_blocks`: reused, new, declined) that landed in a block kept from
an earlier call.  A program without the pool gives None."""

from bench_torch.metrics._spans import records, roots


def read(run):
    deltas = [r.attrs["host_blocks"] for r in roots(records(run), "decode")
              if "host_blocks" in r.attrs]
    total = sum(sum(d.values()) for d in deltas)
    if not total:
        return None
    return 100.0 * sum(d.get("reused", 0) for d in deltas) / total
