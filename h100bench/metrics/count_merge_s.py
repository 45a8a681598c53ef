"""Mean seconds a sample of the window spends merging its count's runs on
the host: the spans ``count.merge`` (``count_reads_kmers``: the merge, the
``ci`` filter and the cap).  From the program's spans line
(``h100bench/spans.py``)."""

from h100bench.spans import mean_total


def read(record: dict) -> float | None:
    return mean_total(record, "count.merge")
