"""Mean seconds a sample of the window spends in the PhaseTimer phase ``BF
weights created``: the call step
(``index/device.py:apply_sample_counts_device``: the index upload, K1, the
write-back)."""

from h100bench.record import mean_phase


def read(record: dict) -> float | None:
    return mean_phase(record, "BF weights created")
