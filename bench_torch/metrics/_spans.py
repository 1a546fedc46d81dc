"""What the readers of the program's own spans share.

The program records its spans (huffman_tpu_torch.utils.timing: span,
spans) only while a torch.profiler session runs, so in a traced run they
are the window's; a root span is one codec call, its descendants share its
`call` id, and a root carries `bytes` (the call's input or output bytes)
and `copied` (the host-device bytes copied during the call, by direction
and host memory kind).  Times are time.time_ns(), the profiler's clock.
Only calls whose root's middle lies in the trace's window are read.  A
program without the recorder gives no span, and every reader None."""

from __future__ import annotations

import importlib

from bench_torch.trace import _length, _merge, _overlap

PAGEABLE = ("h2d.pageable", "d2h.pageable")


def records(run) -> list:
    """The program's closed spans of the calls in the run's window."""
    if run.trace is None:
        return []
    try:
        timing = importlib.import_module("huffman_tpu_torch.utils.timing")
    except ImportError:
        return []
    read = getattr(timing, "spans", None)
    if read is None:
        return []
    w0, w1 = run.trace.window
    recs = [r for r in read() if r.end_ns is not None]
    calls = {r.call for r in recs if r.parent is None
             and w0 <= 0.5e-9 * (r.start_ns + r.end_ns) <= w1}
    return [r for r in recs if r.call in calls]


def roots(recs: list, name: str) -> list:
    return [r for r in recs if r.parent is None and r.name == name]


def ms_per_gib(run, root: str, part: str) -> float | None:
    """Host milliseconds of the spans `part` under the roots `root`, per
    GiB of the roots' bytes."""
    recs = records(run)
    tops = roots(recs, root)
    calls = {r.call for r in tops}
    parts = [r for r in recs if r.call in calls and r.name == part]
    nbytes = sum(r.attrs.get("bytes", 0) for r in tops)
    if not parts or not nbytes:
        return None
    return (1e-6 * sum(r.end_ns - r.start_ns for r in parts)
            / (nbytes / 2**30))


def idle_share(run, root: str) -> float | None:
    """Percent of the roots' wall in which each card runs no kernel,
    memcpy or memset, averaged over the cards."""
    tops = roots(records(run), root)
    walls = _merge((1e-9 * r.start_ns, 1e-9 * r.end_ns) for r in tops)
    wall = _length(walls)
    if not wall:
        return None
    trace = run.trace
    busy = sum(_overlap(_merge((a, b) for _, _, a, b in trace.ops.get(d, ())),
                        walls) for d in trace.devices) / len(trace.devices)
    return 100.0 * (1.0 - busy / wall)


def pageable_share(run, root: str) -> float | None:
    """Percent of the bytes the roots copied between host and device that
    went through pageable host memory."""
    deltas = [r.attrs["copied"] for r in roots(records(run), root)
              if "copied" in r.attrs]
    total = sum(sum(d.values()) for d in deltas)
    if not total:
        return None
    return 100.0 * sum(d.get(k, 0) for d in deltas for k in PAGEABLE) / total
