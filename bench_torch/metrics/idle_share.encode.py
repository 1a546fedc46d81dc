"""Percent of the timed encode calls' wall (spans ("encode", "dumps")) in which
the cell's cards run no kernel, memcpy or memset, averaged over the
cards."""


def read(run):
    if run.trace is None:
        return None
    busy = run.trace.share(("encode", "dumps"), ("kernel", "memcpy", "memset"))
    return None if busy is None else 100.0 - busy
