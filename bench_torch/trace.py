"""Reduction of a torch.profiler trace of the measured window: the device
operations (kernels, memcpys, memsets) of each card, the benchmark's own
spans (record_function "bench.<stage>"), and what the metrics and the
result line read from them.  Times are seconds."""

from __future__ import annotations

import re

import torch

SPAN_PREFIX = "bench."
TOP = 10


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _length(xs) -> float:
    return sum(b - a for a, b in xs)


def short_name(name: str) -> str:
    """A kernel's name without its parameter list and return type."""
    if not name.endswith(")") or name.startswith(("Memcpy", "Memset")):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return re.sub(r"^void ", "", name[:i]).strip() or name
    return name


class Trace:
    """ops[d]: (name, kind, start, end) of card d's operations, kind one
    of kernel, memcpy, memset; spans: (stage, start, end)."""

    def __init__(self, prof: torch.profiler.profile, devices):
        self.devices = [d.index for d in devices]
        self.ops = {d: [] for d in self.devices}
        self.spans = []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start = e.start_ns() * 1e-9
            end = start + e.duration_ns() * 1e-9
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if name.startswith(SPAN_PREFIX):    # the span's GPU mirror
                    continue
                kind = ("memcpy" if name.startswith("Memcpy") else
                        "memset" if name.startswith("Memset") else "kernel")
                self.ops.setdefault(e.device_index(), []).append(
                    (name, kind, start, end))
            elif name.startswith(SPAN_PREFIX):
                self.spans.append((name[len(SPAN_PREFIX):], start, end))
        self.spans.sort(key=lambda s: s[1])
        self.window = ((self.spans[0][1], self.spans[-1][2]) if self.spans
                       else (0.0, 0.0))

    def _busy(self, d, kinds=("kernel", "memcpy", "memset")):
        return _merge((a, b) for _, k, a, b in self.ops.get(d, ())
                      if k in kinds)

    def span_set(self, stages):
        return _merge((a, b) for s, a, b in self.spans if s in stages)

    def share(self, stages, kinds) -> float | None:
        """Percent of the stages' wall in which each card runs an
        operation of `kinds`, averaged over the cards."""
        spans = self.span_set(stages)
        wall = _length(spans)
        if not wall:
            return None
        return 100.0 * sum(_overlap(self._busy(d, kinds), spans)
                           for d in self.devices) / len(self.devices) / wall

    def kernel_seconds(self, pattern: str) -> float:
        """Summed device time of the kernels whose name matches."""
        rx = re.compile(pattern)
        return sum(b - a for ops in self.ops.values()
                   for name, k, a, b in ops
                   if k == "kernel" and rx.search(name))

    def busy_s(self) -> float:
        window = [list(self.window)]
        return sum(_overlap(self._busy(d), window)
                   for d in self.devices) / len(self.devices)

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def breakdown(self) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps of a card in the window, by the stage the
        benchmark was in at the gap's middle."""
        by_name = {}
        for ops in self.ops.values():
            for name, _, a, b in ops:
                key = short_name(name)
                by_name[key] = by_name.get(key, 0.0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = []
        w0, w1 = self.window
        for d in self.devices:
            edges = [w0] + [t for iv in self._busy(d) for t in iv] + [w1]
            for a, b in zip(edges[::2], edges[1::2]):
                a, b = max(a, w0), min(b, w1)
                if b > a:
                    label = self._stage_at(0.5 * (a + b))
                    if len(self.devices) > 1:
                        label += f"@cuda:{d}"
                    gaps.append((label, b - a))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps[:TOP]]}

    def _stage_at(self, t: float) -> str:
        for stage, a, b in self.spans:
            if a <= t < b:
                return stage
        return "between"
