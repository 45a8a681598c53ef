"""The readers of pass 2's extraction counters, ``pass2_extract_parallelism``
and ``pass2_extract_critical_s``, on recorded spans lines: with the
counters, and without them (a program that does not write them, or no
spans line at all), where both read None."""

import importlib
import json

import pytest

FIELDS = ["id", "parent", "kind", "name", "thread", "start", "end"]
PRODUCER = "Thread-1 (worker)"


def sample(t0, extracts, counters=None, with_line=True):
    """A sample whose spans line holds one ``pass2.extract`` span a batch
    (``extracts``: their seconds) and ``counters``."""
    lines = []
    if with_line:
        rows, t = [], t0
        for i, s in enumerate(extracts, start=1):
            rows.append([i, None, "span", "pass2.extract", PRODUCER, t, t + s])
            t += s + 0.25
        line = {"command": "1.1", "clock": "monotonic", "start": t0, "end": t + 1.0,
                "fields": FIELDS, "spans": rows,
                "counters": {"pass2.records": 15154, **(counters or {})},
                "gc": {"collections": [0, 0, 0], "seconds": [0.0, 0.0, 0.0]}}
        lines.append([t0 + 20.0, "[malva-tpu-torch/spans] " + json.dumps(line)])
    return {"t0": t0, "t1": t0 + 21.0, "lines": lines, "k3_windows": 1, "ref_k": 43}


def read(name, samples):
    return importlib.import_module(f"h100bench.metrics.{name}").read(
        {"window": (0.0, 100.0), "setup_s": 50.0, "k": 35, "samples": samples})


def counters(busy_us, critical_us, blocks=1):
    return {"pass2.extract_blocks": blocks, "pass2.extract_busy_us": busy_us,
            "pass2.extract_critical_us": critical_us, "pass2.extract_retries": 0}


def test_one_block_on_one_thread():
    """The viral panel's shape: one block, its busy time the span's."""
    s = [sample(0.0, [12.0], counters(11_900_000, 11_900_000)),
         sample(30.0, [10.0], counters(9_800_000, 9_800_000))]
    assert read("pass2_extract_parallelism", s) == pytest.approx((11.9 / 12 + 9.8 / 10) / 2)
    assert read("pass2_extract_critical_s", s) == pytest.approx((11.9 + 9.8) / 2)


def test_many_blocks_over_batches():
    """The chr cell's shape: a sample's busy time over all its batches'
    spans, its critical paths summed by the program."""
    s = [sample(0.0, [0.05, 0.15], counters(1_200_000, 30_000, blocks=900)),
         sample(30.0, [0.1, 0.1], counters(1_400_000, 50_000, blocks=880))]
    assert read("pass2_extract_parallelism", s) == pytest.approx((1.2 / 0.2 + 1.4 / 0.2) / 2)
    assert read("pass2_extract_critical_s", s) == pytest.approx(0.04)


@pytest.mark.parametrize("name", ["pass2_extract_parallelism", "pass2_extract_critical_s"])
def test_none_without_the_counters(name):
    """The parent's side: a spans line without the counters, or none at
    all, reads None, and a sample that lacks them is left out of a mean."""
    assert read(name, [sample(0.0, [12.0]), sample(30.0, [10.0])]) is None
    assert read(name, [sample(0.0, [12.0], with_line=False)]) is None
    assert read(name, []) is None
    one = read(name, [sample(0.0, [12.0], counters(6_000_000, 6_000_000)), sample(30.0, [10.0])])
    assert one == pytest.approx(0.5 if name == "pass2_extract_parallelism" else 6.0)


def test_no_extraction_span_reads_none():
    """Busy time with no span to divide it by is no parallelism."""
    assert read("pass2_extract_parallelism", [sample(0.0, [], counters(0, 0, blocks=0))]) is None
    assert read("pass2_extract_critical_s", [sample(0.0, [], counters(0, 0, blocks=0))]) == 0.0
