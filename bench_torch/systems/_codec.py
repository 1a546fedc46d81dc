"""What every system binding shares: the codec's configuration from a
configuration file, and the program's kernel-launch counters."""

from __future__ import annotations

import importlib

COUNTED = ("histogram", "encode", "pack2", "scan", "dense_decode",
           "wide_encode", "wide_emit", "wide_decode")
PLAIN = ("histogram", "encode", "pack", "scan", "decode")


def codec_config(config: dict):
    from huffman_tpu_torch.config import CodecConfig
    return CodecConfig(block_bytes=config["block_bytes"],
                       max_code_len=config["max_code_len"],
                       capacity_bits_per_byte=config["capacity_bits_per_byte"],
                       narrow_tol=config["narrow_tol"],
                       spec_bits_per_byte=config["spec_bits_per_byte"])


def counters() -> dict:
    """Kernel launches by wrapper module (ops/cuda/<name>.launches; the
    wide schedule's as wide_schedule), and calls of a plain version on
    CUDA tensors (ops/<name>.cuda_calls, as plain.<name>)."""
    out = {}
    for name in COUNTED:
        mod = importlib.import_module(f"huffman_tpu_torch.ops.cuda.{name}")
        out[name] = mod.launches.n
        if hasattr(mod, "schedule_launches"):
            out["wide_schedule"] = mod.schedule_launches.n
    for name in PLAIN:
        mod = importlib.import_module(f"huffman_tpu_torch.ops.{name}")
        out[f"plain.{name}"] = mod.cuda_calls.n
    return out
