"""Golden CPU codec: the C++ oracle (encoder, decoder, byte histogram),
loaded with ctypes.

cpu_codec.cpp beside this file is the port's own copy of the JAX
package's golden codec; g++ builds it at first use into the port's build
directory, huffman_tpu_torch/build/.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..codebook import Codebook
from . import numpy_codec

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "golden", "cpu_codec.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
_LIB = os.path.join(BUILD_DIR, "libhuffgolden.so")
_lock = threading.Lock()
_lib = None


def _build() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build under a per-process name and rename: concurrent test workers
    # may build at once, and a rename is atomic.
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    # no -march=native: the library may be carried to another host
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                    "-o", tmp, SOURCE],
                   check=True, capture_output=True)
    os.replace(tmp, _LIB)


def load_library() -> ctypes.CDLL:
    """Load (building if needed) the golden codec shared library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(SOURCE):
            raise FileNotFoundError(f"golden codec source not found: {SOURCE}")
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(SOURCE)):
            _build()
        lib = ctypes.CDLL(_LIB)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.huff_encode_bytes.restype = ctypes.c_uint64
        lib.huff_encode_bytes.argtypes = [
            u8p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int32), u8p]
        lib.huff_decode_bytes.restype = ctypes.c_uint64
        lib.huff_decode_bytes.argtypes = [
            u8p, ctypes.c_uint64, u8p, u8p, ctypes.c_int, u8p, ctypes.c_uint64]
        lib.byte_histogram.restype = None
        lib.byte_histogram.argtypes = [u8p, ctypes.c_uint64,
                                       ctypes.POINTER(ctypes.c_uint64)]
        _lib = lib
        return lib


def _as_u8(a) -> np.ndarray:
    if isinstance(a, (bytes, bytearray)):
        return np.frombuffer(a, dtype=np.uint8)
    return np.ascontiguousarray(a, dtype=np.uint8).reshape(-1)


def encode(data, cb: Codebook) -> tuple[np.ndarray, int]:
    """Golden encode. Returns (packed MSB-first bytes, total_bits)."""
    arr = _as_u8(data)
    if arr.size == 0:
        return np.zeros(0, dtype=np.uint8), 0
    lib = load_library()
    max_len = max(int(cb.max_len), 1)
    out = np.zeros(arr.size * max_len // 8 + 16, dtype=np.uint8)
    codes = np.ascontiguousarray(cb.codes, dtype=np.uint32)
    lens = np.ascontiguousarray(cb.lengths, dtype=np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    total_bits = lib.huff_encode_bytes(
        arr.ctypes.data_as(u8p), arr.size,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(u8p))
    return out[: (total_bits + 7) // 8].copy(), int(total_bits)


def decode(stream, n_out: int, cb: Codebook, bit_offset: int = 0) -> np.ndarray:
    """Golden decode of n_out symbols of an MSB-first byte stream, from bit
    `bit_offset` on.  Raises ValueError where the stream reaches a prefix
    that no code has."""
    if n_out == 0:
        return np.zeros(0, dtype=np.uint8)
    lib = load_library()
    syms, lens = cb.decode_table()
    # the decoder peeks 4 bytes past its cursor: 8 bytes of slack
    s = np.concatenate([_as_u8(stream), np.zeros(8, dtype=np.uint8)])
    out = np.zeros(n_out, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    end = lib.huff_decode_bytes(
        s.ctypes.data_as(u8p), bit_offset, syms.ctypes.data_as(u8p),
        lens.ctypes.data_as(u8p), max(int(cb.max_len), 1),
        out.ctypes.data_as(u8p), n_out)
    if end == np.iinfo(np.uint64).max:
        raise ValueError("corrupt stream (golden decoder)")
    return out


def histogram(data) -> np.ndarray:
    """Golden 256-bin byte histogram (int64)."""
    arr = _as_u8(data)
    lib = load_library()
    hist = np.zeros(256, dtype=np.uint64)
    lib.byte_histogram(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       arr.size,
                       hist.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return hist.astype(np.int64)


__all__ = ["encode", "decode", "histogram", "load_library", "numpy_codec",
           "SOURCE"]
