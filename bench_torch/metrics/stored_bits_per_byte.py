"""8 x container bytes / input bytes over the window's roundtrips."""


def read(run):
    return (8.0 * sum(rt["blob_bytes"] for rt in run.records)
            / sum(rt["n"] for rt in run.records))
