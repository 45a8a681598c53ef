"""Mean seconds a sample of the window spends in pass 2's coverage queries:
the spans ``pass2.coverage`` (``pipeline._set_coverages_flat``).  From the
program's spans line (``h100bench/spans.py``)."""

from h100bench.spans import mean_total


def read(record: dict) -> float | None:
    return mean_total(record, "pass2.coverage")
