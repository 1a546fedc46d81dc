"""Percent of the payload bytes that the program's host container calls
swapped, copied or checksummed in pieces on its worker threads, of all
those it worked (the root spans "container.dumps" and "container.loads"
carry them in `container_bytes`: pieces, whole).  A program without the
counter, or whose container calls worked no payload byte on the host,
gives None."""

from bench_torch.metrics._spans import records, roots


def read(run):
    recs = records(run)
    deltas = [r.attrs["container_bytes"]
              for name in ("container.dumps", "container.loads")
              for r in roots(recs, name) if "container_bytes" in r.attrs]
    total = sum(sum(d.values()) for d in deltas)
    if not total:
        return None
    return 100.0 * sum(d.get("pieces", 0) for d in deltas) / total
