"""A run's record and the readers that the metric files share.

The record is what a measured window leaves behind (a plain dict):

* ``window``: (start, end) on the host's monotonic clock, in seconds;
* ``samples``: one dict a completed sample: ``t0``, ``t1``, ``lines``
  (each line the program wrote to stderr, with the time it was written:
  ``[t, text]``), ``k3_windows`` (the windows its reads give K3) and
  ``ref_k``;
* ``device``: with ``--trace 1``, the device's activity from the
  profiler's trace, ``[name, kind, start, seconds]`` on the same clock,
  kind one of ``kernel``, ``gpu_memcpy``, ``gpu_memset``; else None;
* ``setup_s``, ``k``: the set-up's seconds and the k-mer size.

The readers of the program's stderr are copies of ``chip_smoke.py``'s
``phase_walls`` (``tools/multicard_run.py``) and ``upload_parts``, and of
the device time by kernel of its ``trace_summary``.
"""

from __future__ import annotations

import re

TAG = "malva-tpu-torch"
PHASE = re.compile(r"\[" + TAG + r"/([^\]]+)\] Execution Time ([0-9.e+-]+)s")
UPLOAD = re.compile(r"call step: .*index upload ([0-9.e+-]+) s")
LANES = re.compile(r"call step: (\d+) distinct k-mers in (\d+) steps")


def phase_name(raw: str) -> str:
    """A PhaseTimer phase without its counts ("(28409 variants)")."""
    return re.sub(r" \([^)]*\)$", "", raw)


def phases(sample: dict) -> list:
    """[name, start, end] of each PhaseTimer phase of one sample: a phase
    ends when its line is written and began its wall before."""
    out = []
    for t, text in sample["lines"]:
        for m in PHASE.finditer(text):
            out.append([phase_name(m.group(1)), t - float(m.group(2)), t])
    return out


def phase_wall(sample: dict, name: str) -> float | None:
    walls = [end - start for n, start, end in phases(sample) if n == name]
    return sum(walls) if walls else None


def mean_phase(record: dict, name: str) -> float | None:
    """Mean wall of one phase over the window's samples, None where no
    sample logged it."""
    walls = [w for w in (phase_wall(s, name) for s in record["samples"]) if w is not None]
    return sum(walls) / len(walls) if walls else None


def text(sample: dict) -> str:
    return "".join(t for _, t in sample["lines"])


def upload_s(sample: dict) -> float | None:
    m = UPLOAD.search(text(sample))
    return float(m.group(1)) if m else None


def k1_lanes(sample: dict) -> int | None:
    m = LANES.search(text(sample))
    return int(m.group(1)) if m else None


def in_window(record: dict) -> list:
    """The device activity inside the window, clipped to it."""
    if record.get("device") is None:
        return []
    t0, t1 = record["window"]
    out = []
    for name, kind, start, dur in record["device"]:
        a, b = max(start, t0), min(start + dur, t1)
        if b > a:
            out.append([name, kind, a, b - a])
    return out


def busy_intervals(record: dict) -> list:
    """The union of the window's device activity, as [start, end]."""
    spans = sorted([a, a + d] for _, _, a, d in in_window(record))
    merged: list = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_s(record: dict) -> float:
    return sum(b - a for a, b in busy_intervals(record))


def kernel_s(record: dict, name: str) -> tuple[float, int]:
    """(seconds, launches) of the kernels whose name holds ``name``."""
    hits = [d for n, kind, _, d in in_window(record) if kind == "kernel" and name in n]
    return sum(hits), len(hits)


def host_phase_at(record: dict, t: float) -> str:
    """What the host was doing at ``t``: the PhaseTimer phase of the
    sample in flight, or the harness between samples."""
    for s in record["samples"]:
        if s["t0"] <= t <= s["t1"]:
            for name, start, end in phases(s):
                if start <= t <= end:
                    return name
            return "sample, outside a phase"
    return "between samples"


def idle_gaps(record: dict) -> list:
    """[what the host was doing, seconds] of each idle stretch of the
    device in the window, longest first."""
    t0, t1 = record["window"]
    edges = [t0] + [x for ab in busy_intervals(record) for x in ab] + [t1]
    gaps = [(b - a, a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps.sort(reverse=True)
    return [[host_phase_at(record, (a + b) / 2), g] for g, a, b in gaps]


def device_ops(record: dict) -> list:
    """[name, seconds] of the device operations by total time, most first."""
    total: dict = {}
    for name, _, _, d in in_window(record):
        total[name] = total.get(name, 0.0) + d
    return sorted(([n, s] for n, s in total.items()), key=lambda x: -x[1])
