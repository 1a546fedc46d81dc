"""The closed roundtrip loop on card-resident data: set-up copies the
host input to the card once, and one caller then runs whole roundtrips of
that tensor back to back, each encode (tensor to the program's resident
form), then container out (a container in card memory: the timed
encode), then container in, then decode (a tensor in card memory: the
timed decode).  Nothing of the data goes through host memory.

Each stage runs in a span bench.<stage> that the trace reads, and is
recorded with its host wall, which ends once the card has finished the
stage's work (torch.cuda.synchronize), and the process's CPU time.

Every roundtrip is checked after its stages, outside their walls: a
container equal to the first one (torch.equal on the card) is held as
that one, an output equal to the input as the input; any other is copied
to the host and kept.  After the window the containers and outputs are
compared with the reference as the roundtrip loop's are (check.py)."""

from __future__ import annotations

import importlib

import torch

from . import roundtrip
from ..systems._codec import counters


def launches() -> dict:
    """The program's kernel-launch counters, with the payload swap and
    CRC kernel's as crc32 (0 where the program has none)."""
    out = counters()
    try:
        mod = importlib.import_module("huffman_tpu_torch.ops.cuda.crc32")
    except ImportError:
        mod = None
    out["crc32"] = mod.launches.n if mod else 0
    return out


class Loop(roundtrip.Loop):
    """roundtrip.Loop on the card: its LIMITS, STAGES, report and compare,
    with the input a card tensor, stage walls that wait for the card, and
    the outputs checked on the card."""

    def __init__(self, system, arr, traffic: dict, seed: int):
        super().__init__(system, arr, traffic, seed)
        self.device = system.devices[0]
        self.x = torch.from_numpy(arr).to(self.device)
        self.first = None                 # the first container, on the card

    def _stage(self, rec: dict, name: str, fn, arg):
        def waited(a):
            out = fn(a)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return out
        return super()._stage(rec, name, waited, arg)

    def step(self, keep: bool = True) -> dict:
        """One encode -> container -> decode of the resident input; its
        record."""
        before = launches()
        rec = {"n": int(self.x.numel()), "cpu_s": {}}
        enc, info = self._stage(rec, "encode", self.system.encode, self.x)
        buf = self._stage(rec, "dumps", self.system.dumps, enc)
        del enc
        enc = self._stage(rec, "loads", self.system.loads, buf)
        out = self._stage(rec, "decode", self.system.decode, enc)
        del enc
        after = launches()
        info["launches"] = {k: after[k] - before[k] for k in after}
        rec["blob_bytes"], rec["info"] = int(buf.numel()), info
        if keep:
            self.records.append(rec)
            self._keep(buf, out)
        return rec

    def _keep(self, buf: torch.Tensor, out: torch.Tensor) -> None:
        kept = self.kept
        if self.first is None:
            self.first = buf
            kept.blobs.append(None)       # filled in by release()
            kept.which.append(0)
        elif torch.equal(buf, self.first):
            kept.which.append(0)
        else:
            kept.blobs.append(buf.cpu().numpy().tobytes())
            kept.which.append(len(kept.blobs) - 1)
        same = out.shape == self.x.shape and torch.equal(out, self.x)
        kept.outputs.append(None if same else out.cpu().numpy())

    def release(self) -> None:
        """Drop the system and the card's tensors; the first container
        goes to the host for the comparison."""
        if self.first is not None:
            self.kept.blobs[0] = self.first.cpu().numpy().tobytes()
        self.system = self.x = self.first = None
