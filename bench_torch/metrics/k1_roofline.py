"""K1, the dense block encoder (ops/cuda/encode, csrc/encode.cu), against
its bandwidth bound.  A pass over the blocks reads the input bytes and
each block's valid count, and writes each block's bit count and the words
its bits need, at most the pass's capacity: not the capacity rows the
implementation allocates.  Each launch also reads the 256 codes and
lengths.  Passes come from EncodeTrace.capacities_tried; a sharded encode
has none, and makes one pass a launch on each shard with no capacity cut.
A pass under a sampled book that missed is counted with the final book's
words (the two books' sizes differ by well under 1%)."""

import numpy as np

from bench_torch.peaks import roofline

KERNELS = r"encode_rows_warp<[^>]*false>|encode_rows_cta"
TABLES = 2 * 256 * 4


def bytes_of(rt, work) -> int:
    if work.get("format") != "dense":
        return 0
    info, words = rt["info"], work["block_words"]
    caps = info.get("capacities_tried")
    if caps is None:
        caps = [None] * (info["launches"]["encode"] // work["shards"])
    out_words = sum(int(words.sum()) if cap is None
                    else int(np.minimum(words, cap).sum()) for cap in caps)
    return (len(caps) * (rt["n"] + 8 * work["nb"]) + 4 * out_words
            + TABLES * info["launches"]["encode"])


def read(run):
    return roofline(run, KERNELS, bytes_of)
