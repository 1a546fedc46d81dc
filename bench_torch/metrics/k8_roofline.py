"""K8, the wide decoder (ops/cuda/wide_decode, csrc/wide_decode.cu),
against its bandwidth bound: it reads the payload words, each tile's
int64 offset, plane length and 64 int32 round bases and byte count, and
a launch's int16 table of 2^mcl entries, and writes the tiles' bytes
once."""

from bench_torch.peaks import roofline

KERNELS = r"\bwide_decode_kernel\b"
TILE_BYTES = 262144


def bytes_of(rt, work) -> int:
    launches = rt["info"]["launches"]["wide_decode"]
    if work.get("format") != "wide" or not launches:
        return 0
    nt = work["nt"]
    return (4 * work["payload_words"] + nt * (8 + 4 + 256 + 4)
            + 2 * (1 << work["mcl"]) * launches + nt * TILE_BYTES)


def read(run):
    return roofline(run, KERNELS, bytes_of)
