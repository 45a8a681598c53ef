"""Mean bytes a sample copies from the host to the card in the index upload
(``DeviceIndex.from_host``): the counter ``upload.h2d_bytes`` of the
program's spans line (``h100bench/spans.py``)."""

from h100bench.spans import counter, mean


def read(record: dict) -> float | None:
    return mean(record, lambda s: counter(s, "upload.h2d_bytes"))
