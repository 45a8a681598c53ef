"""Mean seconds a sample of the window spends in pass 2's producer at work,
wherever it overlaps other phases: the spans ``pass2.scan`` (the record
scan), ``pass2.gt_parse`` (the GT columns) and ``pass2.extract`` (the
signatures); its waits on the gate and the queue are left out.  From the
program's spans line (``h100bench/spans.py``)."""

from h100bench.spans import mean_total


def read(record: dict) -> float | None:
    return mean_total(record, "pass2.scan", "pass2.gt_parse", "pass2.extract")
