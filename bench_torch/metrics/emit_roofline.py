"""The wide schedule and K7 emit (ops/cuda/wide_emit, csrc/wide_emit.cu)
together against their bandwidth bound: the schedule reads the l2 item
counts and each tile's byte count and writes the 64 int32 round bases and
the plane length of each tile; K7 reads every pulled word and each tile's
int64 offset and writes the payload once.  The pull masks only pass from
one kernel to the other and are not counted."""

from bench_torch.peaks import roofline

KERNELS = r"\bwide_schedule_kernel\b|\bwide_emit_kernel\b"


def bytes_of(rt, work) -> int:
    if work.get("format") != "wide" or not rt["info"]["launches"]["wide_emit"]:
        return 0
    ns, nt = work["ns"], work["nt"]
    return (64 * ns + 4 * nt + nt * (256 + 4) + 8 * work["payload_words"]
            + 8 * nt)


def read(run):
    return roofline(run, KERNELS, bytes_of)
