"""The dense pack, K2+K3 (ops/cuda/pack2, csrc/pack.cu), against its
bandwidth bound: it reads the words each block's bits fill and the
block's bit count, word base (int64) and bit shift, and writes the
stream words once."""

from bench_torch.peaks import roofline

KERNELS = r"\bpack_tiles_kernel\b"


def bytes_of(rt, work) -> int:
    if work.get("format") != "dense" or not rt["info"]["launches"]["pack2"]:
        return 0
    return (4 * int(work["block_words"].sum()) + 16 * work["nb"]
            + 4 * work["stream_words"])


def read(run):
    return roofline(run, KERNELS, bytes_of)
