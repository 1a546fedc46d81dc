"""K4, the dense decoder (ops/cuda/dense_decode, csrc/dense_decode.cu),
against its bandwidth bound: it reads the stream words, each block's
word base (int64), bit shift and valid count, and a launch's int16 table
of 2^table_bits entries, and writes the blocks' bytes once."""

from bench_torch.peaks import roofline

KERNELS = r"\bdecode_blocks_kernel\b"


def bytes_of(rt, work) -> int:
    launches = rt["info"]["launches"]["dense_decode"]
    if work.get("format") != "dense" or not launches:
        return 0
    return (4 * work["stream_words"] + 16 * work["nb"]
            + 2 * (1 << work["table_bits"]) * launches
            + work["nb"] * work["block_bytes"])


def read(run):
    return roofline(run, KERNELS, bytes_of)
