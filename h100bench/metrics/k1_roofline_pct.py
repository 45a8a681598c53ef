"""K1's share of its roofline over the window, in %: the least time of
the lanes each sample's call step ran (``roofline.k1_least_s``, lanes
from the ``call step:`` line) over the device time of every
``callstep_kernel`` launch in the profiler's trace."""

from h100bench.record import k1_lanes, kernel_s
from h100bench.roofline import k1_least_s


def read(record: dict) -> float | None:
    spent, launches = kernel_s(record, "callstep_kernel")
    lanes = [k1_lanes(s) for s in record["samples"]]
    if not launches or spent <= 0 or None in lanes:
        return None
    return 100.0 * sum(k1_least_s(n, record["k"])[0] for n in lanes) / spent
