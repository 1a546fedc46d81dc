"""Benchmark stats logging: JSONL records + gnuplot-style series files.

The same logger as huffman_tpu/utils/stats.py, line for line (it needs no
jax): the CLI's bench logs through it.  Conventions:
  * data rate GB/s = (MB * 1000) / (ms * 1024);
  * one text file per series with a header line naming the axes, so the
    files stay gnuplot-compatible.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


def gb_per_s(megabytes: float, ms: float) -> float:
    """Reference-convention data rate (stats_logger.h:42)."""
    if ms <= 0:
        return 0.0
    return (megabytes * 1000.0) / (ms * 1024.0)


class StatsLogger:
    """Appends JSONL records and mirrors (x, y) points to series files."""

    def __init__(self, directory: str = "bench_logs", run_name: str | None = None):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.run_name = run_name or time.strftime("%Y%m%d_%H%M%S")
        self.jsonl_path = os.path.join(directory, f"{self.run_name}.jsonl")

    def log(self, record: dict[str, Any]) -> dict[str, Any]:
        record = dict(record)
        record.setdefault("ts", time.time())
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        return record

    def log_rate(self, name: str, megabytes: float, ms: float,
                 **extra: Any) -> dict[str, Any]:
        """Log a timed transfer: ms, MB and the derived GB/s series.

        The auto-derived rate series mirrors LogStats2's behavior
        (reference: stats_logger.h:38-43).
        """
        rec = self.log({"series": name, "mb": megabytes, "ms": ms,
                        "gbps": gb_per_s(megabytes, ms), **extra})
        self.add_series_point(f"{name}__time", "MB", "ms", megabytes, ms)
        self.add_series_point(f"{name}__rate", "MB", "GB/s", megabytes,
                              rec["gbps"])
        return rec

    def add_series_point(self, series: str, x_name: str, y_name: str,
                         x: float, y: float) -> None:
        """Append an (x, y) point to a gnuplot-style series file.

        File name / header-line format follows the reference's
        graph__<name>_series.txt convention (stats_logger.cpp:13-27).
        """
        path = os.path.join(self.dir, f"graph__{series}_series.txt")
        fresh = not os.path.exists(path)
        with open(path, "a") as f:
            if fresh:
                f.write(f"# {series}: {x_name} vs {y_name}\n")
            f.write(f"{x:.6f}\t{y:.6f}\n")
