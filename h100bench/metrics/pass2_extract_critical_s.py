"""Mean seconds a sample of the window's pass 2 extraction could take on
threads enough: its longest block's seconds, summed over the sample's
native calls (counter ``pass2.extract_critical_us``).  From the
program's spans line (``h100bench/spans.py``); None from a program
without the counter."""

from h100bench.spans import counter, mean


def critical_s(sample: dict) -> float | None:
    us = counter(sample, "pass2.extract_critical_us")
    return None if us is None else us / 1e6


def read(record: dict) -> float | None:
    return mean(record, critical_s)
