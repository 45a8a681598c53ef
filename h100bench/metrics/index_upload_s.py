"""Mean seconds a sample of the window spends uploading the index to the
card (``index/device.py:DeviceIndex.from_host``), from the program's
``call step:`` line (``index upload X s``)."""

from h100bench.record import upload_s


def read(record: dict) -> float | None:
    walls = [w for w in map(upload_s, record["samples"]) if w is not None]
    return sum(walls) / len(walls) if walls else None
