"""Input bytes encoded in the window (10^9 bytes) over the summed host
wall of those calls, each from its start until the container bytes
exist (encode, then container out)."""


def read(run):
    wall = sum(rt["encode_s"] + rt["dumps_s"] for rt in run.records)
    return sum(rt["n"] for rt in run.records) / wall / 1e9
