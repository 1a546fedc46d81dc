"""Command-line driver of the port.

Usage:
  python -m huffman_tpu_torch encode FILE... [-o OUT.htz] [--verify]
                               [--format auto|dense|wide] [--no-checksum]
                               [--device cuda|cpu]
  python -m huffman_tpu_torch decode FILE.htz... [-o OUT] [--range START:STOP]
                               [--device cuda|cpu]
  python -m huffman_tpu_torch roundtrip FILE... [--device cuda|cpu]

The device defaults to cuda.  --format auto resolves as the JAX package's
does off a TPU: to dense.  decode reads either container version.  --mesh
belongs to a part of the JAX package that is not ported yet, and raises.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import api, container, wide
from .codebook import byte_histogram_host, entropy_bits_per_byte
from .config import CodecConfig


def _cfg(args) -> CodecConfig:
    kw = {}
    if args.block_bytes:
        kw["block_bytes"] = args.block_bytes
    if args.max_code_len:
        kw["max_code_len"] = args.max_code_len
    if args.capacity:
        kw["capacity_bits_per_byte"] = args.capacity
    return CodecConfig(**kw)


def _read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return np.frombuffer(f.read(), dtype=np.uint8)


def _refuse_unported(args) -> None:
    if getattr(args, "mesh", None):
        raise NotImplementedError("--mesh: not yet ported")


def _resolve_format(fmt: str) -> str:
    """'auto' picks what the JAX package picks off a TPU: the dense format
    (its wide format is the TPU's decode path; which format the card should
    default to is an open question of PERF.md)."""
    return "dense" if fmt == "auto" else fmt


def cmd_encode(args) -> int:
    _refuse_unported(args)
    cfg = _cfg(args)
    fmt = _resolve_format(args.format)
    rc = 0
    for path in args.files:
        data = _read(path)
        h = entropy_bits_per_byte(byte_histogram_host(data))
        t0 = time.perf_counter()
        if fmt == "wide":
            enc = wide.encode_wide(data, cfg, device=args.device)
        else:
            enc = api.encode(data, cfg, device=args.device)
        ms = (time.perf_counter() - t0) * 1e3
        out = args.output or (path + ".htz")
        size = container.dump(enc, out, checksum=not args.no_checksum)
        print(f"{path}: {data.size} B, H={h:.4f} bits/B -> {out}: {size} B "
              f"(ratio {size / max(data.size, 1):.4f}) in {ms:.1f} ms "
              f"on {args.device} ({fmt})")
        if args.verify and fmt == "wide":
            ok = np.array_equal(wide.decode_wide(enc, device=args.device),
                                data)
            print(f"  verify roundtrip: {'PASS' if ok else 'FAIL'}")
            rc |= 0 if ok else 1
        elif args.verify:
            from .verify import verify_encoded
            res = verify_encoded(enc, data)
            print(f"  verify vs golden: {'PASS' if res else 'FAIL'} — "
                  f"{res.detail}")
            rc |= 0 if res else 1
    return rc


def cmd_decode(args) -> int:
    _refuse_unported(args)
    for path in args.files:
        enc = container.load(path)
        is_wide = isinstance(enc, wide.WideEncoded)
        t0 = time.perf_counter()
        if args.range:
            a, _, b = args.range.partition(":")
            decode_range = wide.decode_wide_range if is_wide \
                else api.decode_range
            data = decode_range(enc, int(a) if a else 0,
                                int(b) if b else enc.n_bytes,
                                device=args.device)
        elif is_wide:
            data = wide.decode_wide(enc, device=args.device)
        else:
            data = api.decode(enc, device=args.device)
        ms = (time.perf_counter() - t0) * 1e3
        out = args.output or (path[:-4] if path.endswith(".htz")
                              else path + ".out")
        with open(out, "wb") as f:
            f.write(data.tobytes())
        print(f"{path} -> {out}: {data.size} B in {ms:.1f} ms on {args.device}")
    return 0


def cmd_roundtrip(args) -> int:
    from .verify import verify_encoded, verify_roundtrip
    cfg = _cfg(args)
    rc = 0
    for path in args.files:
        data = _read(path)
        enc = api.encode(data, cfg, device=args.device)
        r1 = verify_encoded(enc, data)
        r2 = verify_roundtrip(enc, data, device=args.device)
        print(f"{path}: encode {'PASS' if r1 else 'FAIL'} ({r1.detail}); "
              f"decode {'PASS' if r2 else 'FAIL'} ({r2.detail})")
        rc |= 0 if (r1 and r2) else 1
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="huffman_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")

    def add_config(sp):
        sp.add_argument("files", nargs="+")
        sp.add_argument("--block-bytes", type=int, default=None)
        sp.add_argument("--max-code-len", type=int, default=None)
        sp.add_argument("--capacity", type=int, default=None,
                        help="per-block capacity in bits per input byte")
        add_device(sp)

    sp = sub.add_parser("encode", help="encode files to .htz containers")
    add_config(sp)
    sp.add_argument("-o", "--output", default=None)
    sp.add_argument("--verify", action="store_true",
                    help="bit-exact check against the CPU golden encoder")
    sp.add_argument("--no-checksum", action="store_true",
                    help="skip the container payload CRC-32")
    sp.add_argument("--format", choices=("auto", "dense", "wide"),
                    default="auto",
                    help="container: dense (v1) or wide (v3); auto = dense")
    sp.add_argument("--mesh", default=None, metavar="N|auto")
    sp.set_defaults(fn=cmd_encode)

    sp = sub.add_parser("decode", help="decode .htz containers")
    sp.add_argument("files", nargs="+")
    sp.add_argument("-o", "--output", default=None)
    sp.add_argument("--range", default=None, metavar="START:STOP",
                    help="decode only bytes [START, STOP)")
    sp.add_argument("--mesh", default=None, metavar="N|auto")
    add_device(sp)
    sp.set_defaults(fn=cmd_decode)

    sp = sub.add_parser("roundtrip", help="encode + decode + verify")
    add_config(sp)
    sp.set_defaults(fn=cmd_roundtrip)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
