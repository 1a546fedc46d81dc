"""The payload swap and CRC-32 kernel (ops/cuda/crc32, csrc/crc32.cu)
against its bandwidth bound: a launch reads the stream's W words and
writes them swapped, 4 W bytes each way, W the reference's stream_words
(a container out and one in: two launches a roundtrip)."""

from bench_torch.peaks import roofline

KERNELS = r"\bswap_crc32_kernel\b"


def bytes_of(rt, work) -> int:
    launches = rt["info"]["launches"].get("crc32", 0)
    if work.get("format") != "dense" or not launches:
        return 0
    return 8 * work["stream_words"] * launches


def read(run):
    return roofline(run, KERNELS, bytes_of)
