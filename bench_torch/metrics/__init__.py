"""One reader a metric, found by the metric's name: metrics/<name>.py
holds read(run), which returns the metric's value from a run (its
loop's records, its trace, the work the reference counted) or None where it
finds nothing to read; the harness then leaves the metric out."""
