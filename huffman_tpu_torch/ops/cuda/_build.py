"""Build and load the CUDA kernels of csrc/ at first use.

nvcc compiles every csrc/*.cu for sm_90a, one process per source and all
at once, and links the objects into one shared library with a plain C
interface, in huffman_tpu_torch/build/ (listed in .gitignore); ctypes
loads it.  Nothing is built when a module is imported: the first
kernel launch builds, or `build()` does so explicitly.  Each C entry
returns cudaGetLastError() after its launch and `check` raises on it.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

import torch

PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "build")
LIB = os.path.join(BUILD_DIR, "libhuffman_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None

_p = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
_SIGNATURES = {
    "huff_encode_blocks": [_p, _p, _p, _p, _p, _p, _ll, _i, _i, _p],
    "huff_pack_blocks": [_p, _p, _p, _p, _p, _ll, _i, _ll, _p],
    "huff_decode_blocks": [_p, _ll, _p, _p, _p, _p, _i, _p, _ll, _i, _p],
    "huff_wide_sub_encode": [_p, _p, _p, _p, _p, _p, _p, _ll, _i, _p],
    "huff_wide_schedule": [_p, _p, _p, _p, _p, _i, _i, _p],
    "huff_wide_emit": [_p, _i, _p, _p, _p, _p, _i, _p, _p],
    "huff_wide_decode": [_p, _ll, _p, _p, _p, _p, _p, _i, _p, _i, _p],
    "huff_histogram": [_p, _ll, _p, _p],
    "huff_bit_offsets": [_p, _ll, _i, _i, _p, _p, _p, _p, _p],
    "huff_swap_crc32": [_p, _p, _ll, _i, _p, _p],
    "huff_copy_crc32": [_p, _p, _ll, _p, _p, _p],
    "huff_split_bf16": [_p, _p, _p, _ll, _p],
    "huff_merge_bf16": [_p, _p, _p, _ll, _p],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError("nvcc not found (set CUDA_HOME)")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(LIB):
        return True
    built = os.path.getmtime(LIB)
    deps = _sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(f) > built for f in deps)


def build() -> str:
    """Compile csrc/*.cu into LIB, the sources in parallel.  Returns nvcc's
    output, which holds the `-Xptxas -v` register, shared-memory and spill
    lines of every kernel."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in _sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(_sources(), objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        for p, log in zip(procs, logs):
            if p.returncode:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n{log}")
        tmp = f"{LIB}.{tag}"
        r = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp, LIB)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(logs) + r.stdout + r.stderr


def load_library() -> ctypes.CDLL:
    """The kernels' library, built first if it is missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(LIB)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.huff_cuda_error_string.argtypes = [ctypes.c_int]
            lib.huff_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        msg = load_library().huff_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}: {msg}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Raise unless t is a contiguous `dtype` tensor of `shape` on `device`."""
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(
            f"{name}: want a contiguous {dtype} tensor of shape {shape} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
