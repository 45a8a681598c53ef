"""K3's share of its roofline over the window, in %: the least time of
the windows each sample's reads give K3 (``roofline.k3_least_s``, one
piece a launch) over the device time of every ``seq_pack_kernel``
launch in the profiler's trace."""

from h100bench.record import kernel_s
from h100bench.roofline import k3_least_s


def read(record: dict) -> float | None:
    spent, launches = kernel_s(record, "seq_pack_kernel")
    if not launches or spent <= 0 or not record["samples"]:
        return None
    windows = sum(s["k3_windows"] for s in record["samples"])
    return 100.0 * k3_least_s(windows, launches, record["samples"][0]["ref_k"])[0] / spent
