"""Mean seconds a sample of the window spends with pass 2's consumer waiting
on its producer: the spans ``pass2.wait`` (``pipeline._prefetch``'s queue).
From the program's spans line (``h100bench/spans.py``)."""

from h100bench.spans import mean_total


def read(record: dict) -> float | None:
    return mean_total(record, "pass2.wait")
