"""The program's own spans and counters, from the line each command ends
with: ``[malva-tpu-torch/spans] <json>`` (``malva_tpu_torch/utils/timing.py
PhaseTimer.spans_line``).

The JSON holds the command's id, its ``start`` and the line's ``end``, the
``spans`` as rows of ``fields`` (id, parent, kind, name, thread, start,
end; kind ``phase`` for a PhaseTimer phase, ``span`` for a span inside the
program, ``gc`` for a generation-2 collection), the ``counters`` by name,
and ``gc``: ``collections`` and ``seconds`` by generation.  Stamps are on
the host's monotonic clock, the clock of ``record.py``'s lines and of the
device trace.  A sample from a program without the line reads None.
"""

from __future__ import annotations

import json

from h100bench.record import TAG, text

PREFIX = f"[{TAG}/spans] "


def parse(sample: dict) -> dict | None:
    """The spans record of one sample's command, each span a dict of its
    fields, or None where the command wrote no spans line."""
    for line in text(sample).splitlines():
        if line.startswith(PREFIX):
            rec = json.loads(line[len(PREFIX):])
            rec["spans"] = [dict(zip(rec["fields"], row)) for row in rec["spans"]]
            return rec
    return None


def total_s(sample: dict, names: tuple) -> float | None:
    """Seconds of the sample's spans named in ``names``, summed; None
    without a spans line."""
    rec = parse(sample)
    if rec is None:
        return None
    return sum(s["end"] - s["start"] for s in rec["spans"]
               if s["kind"] == "span" and s["name"] in names)


def counter(sample: dict, name: str) -> float | None:
    rec = parse(sample)
    return None if rec is None else rec["counters"].get(name)


def gc_s(sample: dict) -> float | None:
    """The GC's seconds in the sample's command, all generations."""
    rec = parse(sample)
    return None if rec is None else sum(rec["gc"]["seconds"])


def mean(record: dict, per_sample) -> float | None:
    """Mean of ``per_sample`` over the window's samples, None where no
    sample gives one."""
    vals = [v for v in map(per_sample, record["samples"]) if v is not None]
    return sum(vals) / len(vals) if vals else None


def mean_total(record: dict, *names: str) -> float | None:
    return mean(record, lambda s: total_s(s, names))


def innermost_at(record: dict, t: float) -> str | None:
    """The name of the shortest span (or phase) of the sample in flight
    that covers ``t``; None where no spans line covers it."""
    for s in record["samples"]:
        if s["t0"] <= t <= s["t1"]:
            rec = parse(s)
            if rec is None:
                return None
            covering = [x for x in rec["spans"] if x["kind"] != "gc" and x["start"] <= t <= x["end"]]
            return min(covering, key=lambda x: x["end"] - x["start"])["name"] if covering else None
    return None
