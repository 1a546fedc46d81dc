"""Percent of the timed decode calls' wall (spans ("loads", "decode")) in which
the cell's cards run no kernel, memcpy or memset, averaged over the
cards."""


def read(run):
    if run.trace is None:
        return None
    busy = run.trace.share(("loads", "decode"), ("kernel", "memcpy", "memset"))
    return None if busy is None else 100.0 - busy
