"""Mean seconds a sample of the window spends reading its reads for the
count: the spans ``count.read`` (the batches decompressed, split and
walked, the pieces' bytes joined; ``count/counter.py``).  From the
program's spans line (``h100bench/spans.py``)."""

from h100bench.spans import mean_total


def read(record: dict) -> float | None:
    return mean_total(record, "count.read")
