"""Host milliseconds of container in (container.loads, loads_wide) a GiB
of input, from the benchmark's own span around the call."""


def read(run):
    return (1e3 * sum(rt["loads_s"] for rt in run.records)
            / (sum(rt["n"] for rt in run.records) / 2**30))
