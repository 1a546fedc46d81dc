"""Seconds from the process's start to the window's: imports, the
kernels' library (built by the first run in a checkout), the input drawn
on the card and copied to the host, one roundtrip of the cell's shapes."""


def read(run):
    return run.setup_s
