"""Mean seconds a sample of the window spends parsing pass 2's GT columns:
the spans ``pass2.gt_parse`` on the producer's thread (the native parse of
a batch's GT regions).  From the program's spans line
(``h100bench/spans.py``)."""

from h100bench.spans import mean_total


def read(record: dict) -> float | None:
    return mean_total(record, "pass2.gt_parse")
