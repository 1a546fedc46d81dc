"""Percent of the timed decode calls' wall (spans ("loads", "decode")) in which
the cell's cards run a host-device memcpy, averaged over the cards."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.share(("loads", "decode"), ("memcpy",))
