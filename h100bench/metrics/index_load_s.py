"""Mean seconds a sample of the window spends in the PhaseTimer phase ``Index
loaded``: the index read from its file (``cli.py`` ``call``,
``pipeline.load_index``)."""

from h100bench.record import mean_phase


def read(record: dict) -> float | None:
    return mean_phase(record, "Index loaded")
