"""The split and merge of bf16 planes (ops/cuda/planes, csrc/planes.cu)
against their bandwidth bound: a launch reads and writes 4 bytes an
element of the call's tensor (the split reads the 2-byte words and writes
two 1-byte planes, the merge the reverse), the elements the reference's
(work["elements"], one launch a whole tensor), over the launches that
the trace holds and their summed device time."""

import re

from bench_torch.peaks import HBM_BYTES_PER_S

KERNELS = re.compile(r"\b(split|merge)_bf16_kernel\b")


def read(run):
    elements = (run.work.get("elements")
                if run.work.get("format") == "df11" else None)
    if run.trace is None or not elements:
        return None
    times = [b - a for ops in run.trace.ops.values()
             for name, kind, a, b in ops
             if kind == "kernel" and KERNELS.search(name)]
    if not times:
        return None
    return 100.0 * 4 * elements * len(times) / HBM_BYTES_PER_S / sum(times)
