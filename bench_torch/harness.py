"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the metrics.

Everything that belongs to one cell is found by name.  BENCHMARK.json's
entry gives the configuration, configs/<name>.json, and the traffic,
traffic/<name>.json.  The traffic names its byte profile, drawn by
generators/<profile>.py (gen.py), and its loop, loops/<loop>.py, which
owns the window's unit of work and the comparison after it.  The
configuration names its system binding, systems/<loop>/<system>.py, and
its plain reference, reference/<reference>.py.  Each metric is read by
metrics/<name>.py.

Set-up draws the input on the card from the seed, copies it to the host
and runs one step of the loop to warm every shape the window uses.  The
window then runs steps back to back, at least one, starting one only
while it is open.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from . import gen
from .trace import Trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def log(tag: str, obj) -> None:
    print(f"{tag} {json.dumps(obj)}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its configuration and traffic."""

    def __init__(self, name: str, bench: dict | None = None):
        self.bench = bench or load_json(ROOT / "BENCHMARK.json")
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.spec = found[0]
        self.name, self.chips = name, self.spec["chips"]
        self.config = load_json(
            HERE / "configs" / f"{self.spec['config']}.json")
        self.traffic = load_json(
            HERE / "traffic" / f"{self.spec['traffic']}.json")
        self.loop = importlib.import_module(
            f"bench_torch.loops.{self.traffic['loop']}").Loop
        self.reference = importlib.import_module(
            f"bench_torch.reference.{self.config['reference']}")

    def system(self, device: str):
        mod = importlib.import_module(f"bench_torch.systems."
                                      f"{self.traffic['loop']}."
                                      f"{self.config['system']}")
        return mod.System(self.config, self.chips, device)

    def metric_names(self, trace: bool) -> list[str]:
        if not trace:
            return [m["name"] for m in self.bench["end_to_end"]
                    if self.name in m.get("workloads", [self.name])]
        return [m["name"] for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name])]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_torch.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What the metric readers read."""

    def __init__(self, cell, records, setup_s, trace, work):
        self.cell, self.records, self.setup_s = cell, records, setup_s
        self.trace, self.work = trace, work


def _synchronize(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None,
             system=None) -> dict:
    """One run; `system` replaces the program's binding (the control and
    the planted faults)."""
    t0 = time.perf_counter() if t0 is None else t0
    marks = {"start": time.perf_counter() - t0}
    system = system or cell.system(device)
    devices = system.devices
    x = gen.generate(cell.traffic, seed, devices[0])
    _synchronize(devices)
    marks["drawn"] = time.perf_counter() - t0
    log("input", gen.describe(x))
    arr = x.cpu().numpy()
    del x
    marks["on_host"] = time.perf_counter() - t0
    loop = cell.loop(system, arr, cell.traffic, seed)
    log("warmup", loop.step(keep=False))
    _synchronize(devices)
    gc.collect()
    for d in devices:
        if d.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t0
    marks["warm"] = setup_s
    log("setup", marks)

    error = None
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if devices[0].type == "cuda" else [])
    with (profile(activities=acts) if trace
          else contextlib.nullcontext()) as prof:
        end = time.perf_counter() + seconds   # once the profiler runs
        try:
            while not loop.records or time.perf_counter() < end:
                loop.step()
        except Exception:                 # a failed call fails the run
            error = traceback.format_exc()
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices
                if d.type == "cuda"), default=0)
    for tag, obj in loop.report():
        log(tag, obj)
    tr = Trace(prof, devices) if prof else None
    records = loop.records
    loop.release()
    del system
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()

    x = gen.generate(cell.traffic, seed, devices[0])
    numbers, failed, details, work = loop.compare(
        x, cell.reference, cell.config, cell.chips)
    del x
    log("check", details)
    if error:
        log("error", error)
    run = Run(cell, records, setup_s, tr, work)
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.bench["end_to_end"]
             + cell.bench["per_layer"]}
    for name in cell.metric_names(trace) if records else []:
        value = reader(name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    correct = (error is None and bool(records)
               and all(numbers[k] <= loop.LIMITS[k] for k in numbers))
    result = {"correct": correct, "attempted": len(records) + bool(error),
              "failed": failed + bool(error), "metrics": metrics,
              "device": device_facts(devices, peak)}
    if tr:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s()
        result["breakdown"] = tr.breakdown()
    result["checks"] = {k: {"value": v, "limit": loop.LIMITS[k]}
                        for k, v in numbers.items()}
    return result


def device_facts(devices, peak: int) -> dict:
    if devices[0].type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(devices[0]),
            "count": len(devices), "memory_peak_bytes": peak}
