"""Debug printers: bit-level dumps of codebooks and bitstreams.

The same string builders as huffman_tpu/utils/printers.py, line for line
(they need no jax), over the port's Codebook: tests can assert on them.
"""

from __future__ import annotations

import numpy as np

from ..codebook import Codebook


def bits32(value: int) -> str:
    """32-character bit string of a word (reference: print32Bits)."""
    return format(int(value) & 0xFFFFFFFF, "032b")


def format_codebook(cb: Codebook, only_used: bool = True) -> str:
    """Human-readable codeword table (reference: printdbg_gpu_data style)."""
    lines = ["sym  len  code"]
    for s in range(256):
        L = int(cb.lengths[s])
        if L == 0 and only_used:
            continue
        code = format(int(cb.codes[s]), f"0{L}b") if L else "-"
        ch = chr(s) if 32 <= s < 127 else "."
        lines.append(f"{s:3d} '{ch}' {L:3d}  {code}")
    return "\n".join(lines)


def format_bitstream(words: np.ndarray, total_bits: int,
                     max_bits: int = 512) -> str:
    """Dump a bitstream as a bit string, grouped by words, truncated.

    Reference analogue: printdbg_bitstream / print_compressed_data_file
    (print_helpers.h), which wrote bit dumps for manual diffing.
    """
    shown = min(total_bits, max_bits)
    out = []
    for i in range(0, shown, 32):
        w = bits32(words[i // 32])
        out.append(w[: min(32, shown - i)])
    suffix = f" ... ({total_bits} bits total)" if total_bits > shown else ""
    return " ".join(out) + suffix


def diff_words(a: np.ndarray, b: np.ndarray, limit: int = 10) -> str:
    """First differing words of two streams (reference:
    comparison_helpers.h:5-16 printed per-word diffs on mismatch)."""
    a = np.asarray(a).reshape(-1)
    b = np.asarray(b).reshape(-1)
    n = min(a.size, b.size)
    bad = np.flatnonzero(a[:n] != b[:n])[:limit]
    lines = [f"word {i}: {bits32(a[i])} != {bits32(b[i])}" for i in bad]
    if a.size != b.size:
        lines.append(f"length mismatch: {a.size} vs {b.size} words")
    return "\n".join(lines) if lines else "streams identical"
