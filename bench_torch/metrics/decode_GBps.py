"""Bytes decoded in the window (10^9 bytes) over the summed host wall of
those calls, from the container bytes to the host uint8 array (container
in, then decode)."""


def read(run):
    wall = sum(rt["loads_s"] + rt["decode_s"] for rt in run.records)
    return sum(rt["n"] for rt in run.records) / wall / 1e9
