"""Samples genotyped a minute: the window's completed samples over its
whole wall time, on the host's clock (end to end)."""


def read(record: dict) -> float | None:
    t0, t1 = record["window"]
    return 60.0 * len(record["samples"]) / (t1 - t0) if record["samples"] else None
