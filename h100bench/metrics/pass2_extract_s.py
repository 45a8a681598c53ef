"""Mean seconds a sample of the window spends extracting pass 2's
signatures: the spans ``pass2.extract`` on the producer's thread (the
native engine's block extraction over the haplotype columns).  From the
program's spans line (``h100bench/spans.py``)."""

from h100bench.spans import mean_total


def read(record: dict) -> float | None:
    return mean_total(record, "pass2.extract")
