"""Host milliseconds of container out (container.dumps, dumps_wide) a GiB
of input, from the benchmark's own span around the call."""


def read(run):
    return (1e3 * sum(rt["dumps_s"] for rt in run.records)
            / (sum(rt["n"] for rt in run.records) / 2**30))
