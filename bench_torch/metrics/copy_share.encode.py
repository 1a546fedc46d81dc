"""Percent of the timed encode calls' wall (spans ("encode", "dumps")) in which
the cell's cards run a host-device memcpy, averaged over the cards."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.share(("encode", "dumps"), ("memcpy",))
