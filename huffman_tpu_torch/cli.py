"""Command-line driver of the port (huffman_tpu/cli.py).

Usage:
  python -m huffman_tpu_torch encode FILE... [-o OUT.htz] [--verify]
                               [--format auto|dense|wide] [--no-checksum]
                               [--mesh N|auto] [--device cuda|cpu]
  python -m huffman_tpu_torch decode FILE.htz... [-o OUT] [--range START:STOP]
                               [--mesh N|auto] [--device cuda|cpu]
  python -m huffman_tpu_torch roundtrip FILE... [--device cuda|cpu]
  python -m huffman_tpu_torch bench FILE... [--iters N] [--mesh N|auto]
                               [--verify] [--log-dir DIR] [--device cuda|cpu]
  python -m huffman_tpu_torch info FILE.htz...     # container header dump
  python -m huffman_tpu_torch devices              # device probe

The device defaults to cuda.  --format auto resolves as the JAX package's
does off a TPU: to dense (and --verify and --mesh always take dense).
decode reads either container version.  --mesh routes through
parallel.pipeline.ShardedCodec: N shards over the first N devices of
--device's type (on cpu, N shards of the one CPU device), or with auto
every device of that type.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import api, container, wide
from .codebook import byte_histogram_host, entropy_bits_per_byte
from .config import CodecConfig
from .utils.device import describe_devices
from .utils.stats import StatsLogger
from .utils.timing import HostTimer, time_fn


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


def _resolve_format(fmt: str) -> str:
    """'auto' picks what the JAX package picks off a TPU: the dense format
    (its wide format is the TPU's decode path; which format the card should
    default to is an open question of PERF.md)."""
    return "dense" if fmt == "auto" else fmt


def _mesh_codec(args, cfg):
    """--mesh N|auto -> a ShardedCodec over N (or all) devices of --device's
    type; None without --mesh."""
    spec = getattr(args, "mesh", None)
    if not spec:
        return None
    from .parallel.mesh import make_mesh
    from .parallel.pipeline import ShardedCodec
    from .utils.device import probe_devices
    devs = probe_devices(torch.device(args.device).type)
    if spec == "auto":
        return ShardedCodec(make_mesh(devices=devs), cfg)
    nd = int(spec)
    if devs[0].type == "cpu":
        devs = devs * nd
    return ShardedCodec(make_mesh(nd, devices=devs), cfg)


def cmd_encode(args) -> int:
    cfg = _cfg(args)
    fmt = _resolve_format(args.format)
    sc = _mesh_codec(args, cfg)
    rc = 0
    for path in args.files:
        data = _read(path)
        h = entropy_bits_per_byte(byte_histogram_host(data))
        with HostTimer() as t:
            if fmt == "wide":
                enc = (sc.encode_wide(data) if sc is not None
                       else wide.encode_wide(data, cfg, device=args.device))
            else:
                enc = (sc.encode(data) if sc is not None
                       else api.encode(data, cfg, device=args.device))
        out = args.output or (path + ".htz")
        size = container.dump(enc, out, checksum=not args.no_checksum)
        where = f"{sc.mesh.size} shards of {args.device}" if sc else args.device
        print(f"{path}: {data.size} B, H={h:.4f} bits/B -> {out}: {size} B "
              f"(ratio {size / max(data.size, 1):.4f}) in {t.ms:.1f} ms "
              f"on {where} ({fmt})")
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
    sc = None
    for path in args.files:
        enc = container.load(path)
        is_wide = isinstance(enc, wide.WideEncoded)
        with HostTimer() as t:
            if args.range:
                a, _, b = args.range.partition(":")
                decode_range = wide.decode_wide_range if is_wide \
                    else api.decode_range
                data = decode_range(enc, int(a) if a else 0,
                                    int(b) if b else enc.n_bytes,
                                    device=args.device)
            elif args.mesh:
                sc = sc or _mesh_codec(args, enc.config)
                data = sc.decode_wide(enc) if is_wide else sc.decode(enc)
            elif is_wide:
                data = wide.decode_wide(enc, device=args.device)
            else:
                data = api.decode(enc, device=args.device)
        out = args.output or (path[:-4] if path.endswith(".htz")
                              else path + ".out")
        with open(out, "wb") as f:
            f.write(data.tobytes())
        print(f"{path} -> {out}: {data.size} B in {t.ms:.1f} ms on "
              f"{args.device}")
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


def cmd_bench(args) -> int:
    """Median encode time of each file: with --mesh, the sharded encode
    from the host array; without, the device-resident K1 + scan + pack
    pipeline on one device (api.encode_pipeline)."""
    cfg = _cfg(args)
    logger = StatsLogger(args.log_dir)
    sc = _mesh_codec(args, cfg)
    rc = 0
    for path in args.files:
        data = _read(path)
        mb = data.size / 2**20
        cb = api.build_codebook(data, cfg, device=args.device)
        if sc is not None:
            def bench_fn():
                return sc.encode(data, codebook=cb)
        else:
            dev = torch.device(args.device)
            blocks, valid = api.device_blocks(data, cfg, dev)
            codes, lengths = api.codebook_tensors(cb, dev)

            def bench_fn():
                return api.encode_pipeline(blocks, codes, lengths, valid,
                                           cfg.capacity_words)
        st = time_fn(bench_fn, iters=args.iters, device=args.device)
        rec = logger.log_rate("encode", mb, st["median_ms"], file=path,
                              bytes=int(data.size), iters=args.iters,
                              device=args.device,
                              shards=sc.mesh.size if sc else 1)
        print(f"{path}: encode {st['median_ms']:.3f} ms median "
              f"({args.iters} iters) = {rec['gbps']:.3f} GB/s on "
              f"{args.device}" + (f", {sc.mesh.size} shards" if sc else ""))
        if args.verify:
            from .verify import verify_encoded
            enc = (sc.encode(data, codebook=cb) if sc is not None
                   else api.encode(data, cfg, codebook=cb, device=args.device))
            res = verify_encoded(enc, data)
            print(f"  verify: {'PASS' if res else 'FAIL'} — {res.detail}")
            rc |= 0 if res else 1
    return rc


def cmd_info(args) -> int:
    for path in args.files:
        enc = container.load(path)
        used = int((enc.codebook.lengths > 0).sum())
        if isinstance(enc, wide.WideEncoded):
            print(f"{path}: v{container.WIDE_VERSION} (wide), {enc.n_bytes} B "
                  f"original, {enc.payload_words.size} payload words, "
                  f"{len(enc.tile_words)} tiles, {used} symbols, "
                  f"max code len {enc.codebook.max_len}")
        else:
            print(f"{path}: v{container.VERSION} (dense), {enc.n_bytes} B "
                  f"original, {enc.total_bits} bits payload, "
                  f"{len(enc.block_bits)} blocks "
                  f"x {enc.config.block_bytes} B, {used} symbols, "
                  f"max code len {enc.codebook.max_len}, "
                  f"overhead {container.overhead_bytes(len(enc.block_bits))} B")
    return 0


def cmd_devices(args) -> int:
    print(describe_devices())
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="huffman_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device type to run on (default: cuda)")

    def add_mesh(sp):
        sp.add_argument("--mesh", default=None, metavar="N|auto",
                        help="shard over N (or all) devices of --device's "
                        "type through ShardedCodec")

    def add_config(sp):
        sp.add_argument("files", nargs="+")
        sp.add_argument("--block-bytes", type=int, default=None)
        sp.add_argument("--max-code-len", type=int, default=None)
        sp.add_argument("--capacity", type=int, default=None,
                        help="per-block capacity in bits per input byte")
        add_device(sp)

    sp = sub.add_parser("encode", help="encode files to .htz containers")
    add_config(sp)
    add_mesh(sp)
    sp.add_argument("-o", "--output", default=None)
    sp.add_argument("--verify", action="store_true",
                    help="bit-exact check against the CPU golden encoder")
    sp.add_argument("--no-checksum", action="store_true",
                    help="skip the container payload CRC-32")
    sp.add_argument("--format", choices=("auto", "dense", "wide"),
                    default="auto",
                    help="container: dense (v1) or wide (v3); auto = dense")
    sp.set_defaults(fn=cmd_encode)

    sp = sub.add_parser("decode", help="decode .htz containers")
    sp.add_argument("files", nargs="+")
    sp.add_argument("-o", "--output", default=None)
    sp.add_argument("--range", default=None, metavar="START:STOP",
                    help="decode only bytes [START, STOP)")
    add_mesh(sp)
    add_device(sp)
    sp.set_defaults(fn=cmd_decode)

    sp = sub.add_parser("roundtrip", help="encode + decode + verify")
    add_config(sp)
    sp.set_defaults(fn=cmd_roundtrip)

    sp = sub.add_parser("bench", help="encode timing loop (median of N iters)")
    add_config(sp)
    add_mesh(sp)
    sp.add_argument("--iters", type=int, default=10)
    sp.add_argument("--verify", action="store_true")
    sp.add_argument("--log-dir", default="bench_logs")
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("info", help="dump container headers")
    sp.add_argument("files", nargs="+")
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("devices", help="list torch devices")
    sp.set_defaults(fn=cmd_devices)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
