"""The closed roundtrip loop: one caller runs whole roundtrips of the host
input back to back, each encode, then container out (the timed encode),
then container in, then decode (the timed decode); the container bytes
stay in host memory.  Every roundtrip's container and decoded output is
kept (check.Outputs) and compared with the reference after the window.

Each stage runs in a span bench.<stage> that the trace reads, and is
recorded with its host wall and the process's CPU time (all threads), so
a run's standard error tells work from waiting."""

from __future__ import annotations

import time

from torch.profiler import record_function

from .. import check
from ..systems._codec import counters


class Loop:
    LIMITS = {"encoded_mismatches": 0, "decoded_mismatches": 0}
    STAGES = ("encode", "dumps", "loads", "decode")

    def __init__(self, system, arr, traffic: dict, seed: int):
        self.system, self.arr = system, arr
        self.records, self.kept = [], check.Outputs(arr)

    def _stage(self, rec: dict, name: str, fn, arg):
        w0, c0 = time.perf_counter(), time.process_time()
        with record_function(f"bench.{name}"):
            out = fn(arg)
        rec[f"{name}_s"] = time.perf_counter() - w0
        rec["cpu_s"][name] = time.process_time() - c0
        return out

    def step(self, keep: bool = True) -> dict:
        """One encode -> container -> decode of the input; its record."""
        before = counters()
        rec = {"n": int(self.arr.size), "cpu_s": {}}
        enc, info = self._stage(rec, "encode", self.system.encode, self.arr)
        blob = self._stage(rec, "dumps", self.system.dumps, enc)
        del enc
        enc = self._stage(rec, "loads", self.system.loads, blob)
        out = self._stage(rec, "decode", self.system.decode, enc)
        del enc
        after = counters()
        info["launches"] = {k: after[k] - before[k] for k in after}
        rec["blob_bytes"], rec["info"] = len(blob), info
        if keep:
            self.records.append(rec)
            self.kept.add(blob, out)
        return rec

    def report(self):
        rows = [[[r[f"{s}_s"], r["cpu_s"][s]] for s in self.STAGES]
                for r in self.records]
        out = [("roundtrips", {"stages": self.STAGES, "wall_cpu": rows})]
        if self.records:
            out.append(("launches", self.records[-1]["info"]["launches"]))
        return out

    def release(self) -> None:
        self.system = None

    def compare(self, x, reference, config: dict, chips: int):
        numbers, failed, details, work = check.compare(
            x, reference, config, chips, self.kept)
        self.kept = None
        return numbers, failed, details, work
