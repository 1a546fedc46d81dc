"""K5, the wide substream encoder (ops/cuda/wide_encode, K1's row encoder
with per-item bit counts), against its bandwidth bound: it reads the
256-byte substream rows, their valid counts and the 256 codes and
lengths, and writes the words each substream's bits fill (not its slot
row), its bit count and its 64 item bit counts (l2)."""

from bench_torch.peaks import roofline

KERNELS = r"encode_rows_warp<[^>]*true>"


def bytes_of(rt, work) -> int:
    if work.get("format") != "wide" or not rt["info"]["launches"]["wide_encode"]:
        return 0
    ns = work["ns"]
    return 256 * ns + 4 * ns + 2 * 256 * 4 + 4 * work["sub_words"] \
        + 4 * ns + 64 * ns


def read(run):
    return roofline(run, KERNELS, bytes_of)
