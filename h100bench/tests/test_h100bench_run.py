"""The run's command: it refuses to measure without a card, and its last
line has the contract's keys, ``checks`` last."""

import json

import pytest

from h100bench import run
from conftest import tiny_chr


def test_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(run, "card", lambda chips: None)
    rc = run.main(["--workload", "chr20-1kgp3.call-30x", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "no CUDA card" in out.err


def test_refuses_without_the_program_in_its_checkout(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(run, "ROOT", str(tmp_path))
    monkeypatch.setattr(run, "load_cell", lambda name: ({}, {}, {}))
    rc = run.main(["--workload", "chr20-1kgp3.call-30x", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "not in this checkout" in out.err


def test_refuses_on_this_machine_without_cuda(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "chr20-1kgp3.call-30x", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(trace, capsys, monkeypatch, tmp_path):
    cfg, wl = tiny_chr()
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(run, "load_cell", lambda name: (bench, wl, cfg))
    monkeypatch.setattr(run, "card", lambda chips: {"platform": "cpu", "kind": "cpu",
                                                    "count": chips})
    monkeypatch.setattr(run, "BACKEND", "host")
    rc = run.main(["--workload", "chr20-1kgp3.call-30x", "--seed", str(2**33 + 5),
                   "--seconds", "0.5", "--trace", str(trace)])
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and ("breakdown" in keys) == bool(trace)
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) <= {m["name"] for m in bench["per_layer"]}
    else:
        assert set(line["metrics"]) == {"samples_per_min", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    err = out.err.strip().splitlines()
    assert err[-2:] == [f"[h100bench] check {n} {c['value']} limit {c['limit']}"
                        for n, c in line["checks"].items()]


def test_metric_units_follow_the_benchmark():
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    for w in bench["workloads"]:
        assert run.metric_units(bench, w["name"], False) == {"samples_per_min": "samples/min",
                                                             "setup_s": "s"}
        assert run.metric_units(bench, w["name"], True)["device_idle_pct"] == "%"


def test_every_cell_has_its_files():
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    for w in bench["workloads"]:
        _, wl, cfg = run.load_cell(w["name"])
        assert wl["config"] == w["config"] == cfg["name"]
        assert run.genotyper_flags(cfg["flags"]).verbose


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  run.load_json(run.ROOT, "BENCHMARK.json")["workloads"]])
def test_cell_on_the_card(card, cell, capsys):
    rc = run.main(["--workload", cell, "--seed", "7", "--seconds", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] and line["device"]["kind"] == card
