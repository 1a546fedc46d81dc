"""Bytes that the card-resident roundtrips copy between host and card, in
any direction and host memory (the `copied` counts of that path's root
spans: "encode" and "decode" with resident=True, "container.dumps" and
"container.loads" with device=True), in percent of the bytes those
roundtrips encode (the encode roots' `bytes`).  A program without that
path records no such root, and the reader gives None."""

from bench_torch.metrics._spans import records

FLAGS = {"encode": "resident", "decode": "resident",
         "container.dumps": "device", "container.loads": "device"}


def read(run):
    tops = [r for r in records(run) if r.parent is None
            and r.attrs.get(FLAGS.get(r.name, ""))]
    nbytes = sum(r.attrs.get("bytes", 0) for r in tops
                 if r.name == "encode")
    if not nbytes:
        return None
    copied = sum(sum(r.attrs.get("copied", {}).values()) for r in tops)
    return 100.0 * copied / nbytes
