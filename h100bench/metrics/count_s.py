"""Mean seconds a sample of the window spends in the PhaseTimer phase ``Sample
k-mer counting``: the sample's reads counted on the card
(``count/counter.py``, ``count/device_count.py``, K3 and the sort)."""

from h100bench.record import mean_phase


def read(record: dict) -> float | None:
    return mean_phase(record, "Sample k-mer counting")
