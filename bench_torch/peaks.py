"""The table of peaks and the roofline arithmetic of the kernel metrics.

A kernel's roofline share is the least time the card could take for the
bytes its launches in the window must move, read once and written once
at the card's published HBM bandwidth, over the device time of those
launches in the trace, in percent.  The bytes are what the input needs
(metrics/<kernel>_roofline.py each hold their own count), not the
buffers the implementation allocates.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80GB data sheet: HBM3 at 3.35 TB/s, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12


def roofline(run, pattern: str, bytes_of) -> float | None:
    """Percent of the bandwidth bound of the kernels matching `pattern`:
    the sum over the window's records of bytes_of(record, work),
    over their summed device time.  None where the trace holds no such
    launch or the records no such work."""
    if run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(pattern)
    nbytes = sum(bytes_of(rt, run.work) for rt in run.records)
    if not seconds or not nbytes:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
