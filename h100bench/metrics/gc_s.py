"""Mean seconds a sample of the window spends in Python's garbage collector,
all generations, from the program's ``gc.callbacks`` hook in its spans
line (``h100bench/spans.py``)."""

from h100bench.spans import gc_s, mean


def read(record: dict) -> float | None:
    return mean(record, gc_s)
