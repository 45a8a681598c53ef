"""The card's idle share of the window, in %: the time in which no
kernel, copy or memset ran, from the profiler's trace."""

from h100bench.record import busy_s


def read(record: dict) -> float | None:
    if record.get("device") is None:
        return None
    t0, t1 = record["window"]
    return 100.0 * (1.0 - busy_s(record) / (t1 - t0))
