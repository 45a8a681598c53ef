"""The readers of the program's spans line (``spans.py``) and the metrics
read from it, on recorded stderr; a sample without the line (a program
that does not write one) reads None."""

import importlib
import importlib.util
import json

import pytest

from h100bench import record as rec
from h100bench import spans
from h100bench.run import HERE, load_json, ROOT

FIELDS = ["id", "parent", "kind", "name", "thread", "start", "end"]
NEW = ["pass2_wait_s", "pass2_produce_s", "pass2_coverage_s", "pass2_format_s", "count_read_s",
       "count_merge_s", "gc_s", "index_upload_bytes", "pass2_gt_parse_s", "pass2_extract_s"]


def spans_line(t0, scale, upload_bytes=2_300_000_000):
    """A command's spans line: each span ``scale`` times a base length."""
    rows, t, i = [], t0, 1

    def add(name, seconds, kind="span", thread="MainThread"):
        nonlocal t, i
        rows.append([i, None if kind != "span" else 1, kind, name, thread, t, t + seconds])
        t += seconds
        i += 1

    for name, s in [("index.load", 0.5), ("count.read", 0.4), ("count.piece", 0.1),
                    ("count.merge", 0.2), ("count.merge", 0.05), ("step.upload", 0.6),
                    ("pass2.wait", 0.3), ("pass2.coverage", 0.2), ("pass2.genotype", 0.1),
                    ("pass2.format", 0.4), ("pass2.wait", 0.1)]:
        add(name, s * scale)
    t = t0
    for name, s in [("pass2.scan", 0.2), ("pass2.gt_parse", 0.7), ("pass2.extract", 0.3),
                    ("pass2.put_wait", 0.5), ("pass2.held", 0.6)]:
        add(name, s * scale, thread="Thread-1 (worker)")
    add("gc.gen2", 0.25 * scale, kind="gc")
    add("VCF parsing and genotyping (28409 variants)", 1.0 * scale, kind="phase")
    line = {"command": "1.1", "clock": "monotonic", "start": t0, "end": t0 + 10 * scale,
            "fields": FIELDS, "spans": rows,
            "counters": {"upload.h2d_bytes": upload_bytes, "pass2.batches": 7,
                         "pass2.records": 28409, "count.windows": 30_200_000},
            "gc": {"collections": [900, 80, 2], "seconds": [0.1 * scale, 0.2 * scale,
                                                          0.25 * scale]}}
    return "[malva-tpu-torch/spans] " + json.dumps(line)


def sample(t0, scale, with_line=True):
    lines = [[t0 + 1.0, "[malva-tpu-torch/Index loaded] Execution Time 0.5s\n"]]
    if with_line:
        text = spans_line(t0, scale)
        lines += [[t0 + 9.0, text], [t0 + 9.0, "\n"]]  # print writes the text, then its end
    lines.append([t0 + 9.5, "[malva-tpu-torch/metrics] main returned at 1.0 s (epoch); the "
                            "process exits after\n"])
    return {"t0": t0, "t1": t0 + 10 * scale, "lines": lines, "k3_windows": 1, "ref_k": 43}


@pytest.fixture
def record():
    return {"window": (100.0, 130.0), "setup_s": 30.0, "k": 35, "device": None,
            "samples": [sample(100.0, 1.0), sample(110.0, 2.0)]}


def read(name, record):
    return importlib.import_module(f"h100bench.metrics.{name}").read(record)


def test_readers(record):
    mean = 1.5  # the two samples' scales, 1 and 2
    assert read("pass2_wait_s", record) == pytest.approx(0.4 * mean)
    assert read("pass2_produce_s", record) == pytest.approx(1.2 * mean)
    assert read("pass2_gt_parse_s", record) == pytest.approx(0.7 * mean)
    assert read("pass2_extract_s", record) == pytest.approx(0.3 * mean)
    assert read("pass2_coverage_s", record) == pytest.approx(0.2 * mean)
    assert read("pass2_format_s", record) == pytest.approx(0.5 * mean)
    assert read("count_read_s", record) == pytest.approx(0.4 * mean)
    assert read("count_merge_s", record) == pytest.approx(0.25 * mean)
    assert read("gc_s", record) == pytest.approx(0.55 * mean)
    assert read("index_upload_bytes", record) == 2_300_000_000


def test_a_sample_without_the_line_is_left_out(record):
    record["samples"].append(sample(130.0, 5.0, with_line=False))
    assert read("pass2_wait_s", record) == pytest.approx(0.6)
    assert spans.parse(record["samples"][-1]) is None


@pytest.mark.parametrize("name", NEW)
def test_a_parent_without_the_line_reads_none(name, record):
    record["samples"] = [sample(100.0, 1.0, with_line=False), sample(110.0, 1.0, with_line=False)]
    assert read(name, record) is None


def test_parse(record):
    line = spans.parse(record["samples"][0])
    assert line["command"] == "1.1" and len(line["spans"]) == 18
    assert line["spans"][0] == {"id": 1, "parent": 1, "kind": "span", "name": "index.load",
                                "thread": "MainThread", "start": 100.0, "end": 100.5}
    assert spans.counter(record["samples"][0], "pass2.records") == 28409
    assert spans.counter(record["samples"][0], "no.such") is None


def test_innermost_span(record):
    # sample 1, main thread: index.load [100, 100.5), count.read [100.5,
    # 100.9), ..., pass2.genotype [102.35, 102.45); the producer: scan
    # [100, 100.2), GT parse [100.2, 100.9), ...; a collection [102.3,
    # 102.55), then the phase [102.55, 103.55)
    assert spans.innermost_at(record, 100.1) == "pass2.scan"
    assert spans.innermost_at(record, 100.7) == "count.read"  # shorter than the GT parse
    assert spans.innermost_at(record, 102.4) == "pass2.genotype"  # not the collection
    assert spans.innermost_at(record, 103.0) == "VCF parsing and genotyping (28409 variants)"
    assert spans.innermost_at(record, 105.0) is None  # in the sample, outside every span
    assert spans.innermost_at(record, 140.0) is None  # between samples


def test_the_line_matches_no_older_pattern(record):
    text = spans_line(0.0, 1.0)
    for pattern in (rec.PHASE, rec.UPLOAD, rec.LANES):
        assert pattern.search(text) is None
    assert [p[0] for p in rec.phases(record["samples"][0])] == ["Index loaded"]


def test_every_new_metric_is_declared():
    bench = load_json(ROOT, "BENCHMARK.json")
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["moves"] == "samples_per_min"
        assert m["workloads"] == [w["name"] for w in bench["workloads"]]
        assert importlib.util.find_spec(f"h100bench.metrics.{name}").origin.startswith(HERE)


def test_traced_host_run_reads_the_spans(capsys, monkeypatch, tmp_path):
    """The tiny cell on the host route, traced: the metrics of the spans
    line are read (the upload's bytes need the card's route)."""
    from h100bench import run
    from conftest import tiny_chr

    cfg, wl = tiny_chr()
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(run, "load_cell", lambda name: (bench, wl, cfg))
    monkeypatch.setattr(run, "card", lambda chips: {"platform": "cpu", "kind": "cpu",
                                                    "count": chips})
    monkeypatch.setattr(run, "BACKEND", "host")
    rc = run.main(["--workload", "chr20-1kgp3.call-30x", "--seed", str(2**32 + 11),
                   "--seconds", "0.5", "--trace", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    got = {n: m["value"] for n, m in line["metrics"].items()}
    assert set(NEW) - {"index_upload_bytes"} <= set(got)
    assert all(got[n] >= 0 for n in NEW if n in got)
    consumer = got["pass2_wait_s"] + got["pass2_coverage_s"] + got["pass2_format_s"]
    assert consumer <= got["pass2_s"]
