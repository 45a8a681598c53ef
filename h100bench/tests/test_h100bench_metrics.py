"""Every metric reader, on recorded stderr and trace text."""

import importlib
import json
import os

import pytest

from h100bench import record as rec
from h100bench.run import HERE, ROOT

T = "[malva-tpu-torch/{}] Execution Time {}s\n"
STEP = ("[malva-tpu-torch/metrics] call step: {} distinct k-mers in 1 steps, step time "
        "0.377536 ms (K1 launcher events), rate 2.6e+12 k-mers/s; index upload {} s (table "
        "0.1 s, minifilter 0.2 s, copy 0.3 s, pack 0.1 s), write-back 0.01 s\n")


def sample(t0, walls, lanes, upload, k3_windows=30_200_000):
    """A sample's stderr as the program writes it, each line at the end of
    its phase."""
    lines, t = [], t0
    for name, w in walls:
        t += w
        lines.append([t, T.format(name, w)])
        if name == "Sample k-mer counting":
            lines.append([t, STEP.format(lanes, upload)])
    return {"t0": t0, "t1": t + 0.01, "lines": lines, "k3_windows": k3_windows, "ref_k": 43}


WALLS = [("Index loaded", 0.5), ("Reference processed", 0.01), ("Sample k-mer counting", 1.5),
         ("BF weights created", 0.9), ("VCF parsing and genotyping (28409 variants)", 1.0)]


@pytest.fixture
def record():
    s1 = sample(100.0, WALLS, 1_000_000, 0.8)
    s2 = sample(s1["t1"], [(n, 2 * w) for n, w in WALLS], 3_000_000, 1.2)
    kernels = [["void callstep_kernel<(Mode)1>(...)", "kernel", 101.0, 0.002],
               ["void callstep_kernel<(Mode)1>(...)", "kernel", 106.0, 0.004],
               ["seq_pack_kernel(...)", "kernel", 101.5, 0.001],
               ["seq_pack_kernel(...)", "kernel", 105.0, 0.001],
               ["Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 102.0, 0.5],
               ["Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 102.25, 0.5],  # overlaps
               ["Memset (Device)", "gpu_memset", 99.0, 1.5]]  # starts before the window
    return {"window": (100.0, s2["t1"]), "setup_s": 41.5, "k": 35, "samples": [s1, s2],
            "device": kernels}


def read(name, record):
    return importlib.import_module(f"h100bench.metrics.{name}").read(record)


def test_phases(record):
    assert read("index_load_s", record) == pytest.approx(0.75)
    assert read("count_s", record) == pytest.approx(2.25)
    assert read("bf_weights_s", record) == pytest.approx(1.35)
    assert read("pass2_s", record) == pytest.approx(1.5)
    assert read("index_upload_s", record) == pytest.approx(1.0)
    assert rec.phases(record["samples"][0])[0] == ["Index loaded", 100.0, 100.5]


def test_end_to_end(record):
    t0, t1 = record["window"]
    assert read("samples_per_min", record) == pytest.approx(120.0 / (t1 - t0))
    assert read("setup_s", record) == 41.5


def test_device(record):
    # busy: [100, 100.5) of the memset, the two kernels at 101 and 101.5,
    # the copies' union [102, 102.75), and the later kernels
    busy = 0.5 + 0.002 + 0.001 + 0.75 + 0.001 + 0.004
    t0, t1 = record["window"]
    assert rec.busy_s(record) == pytest.approx(busy)
    assert read("device_idle_pct", record) == pytest.approx(100 * (1 - busy / (t1 - t0)))
    ops = rec.device_ops(record)
    assert ops[0][0].startswith("Memcpy HtoD") and ops[0][1] == pytest.approx(1.0)
    gaps = rec.idle_gaps(record)
    assert gaps[0][1] == max(g for _, g in gaps)
    assert sum(g for _, g in gaps) == pytest.approx(t1 - t0 - busy)
    # the gap from 102.75 to 105 has its middle in the first sample's pass 2
    assert ["VCF parsing and genotyping", pytest.approx(2.25)] in gaps


def test_rooflines(record):
    from h100bench.roofline import k1_least_s, k3_least_s

    k1 = read("k1_roofline_pct", record)
    assert k1 == pytest.approx(100 * (k1_least_s(1_000_000, 35)[0] + k1_least_s(3_000_000, 35)[0])
                               / 0.006)
    k3 = read("k3_roofline_pct", record)
    assert k3 == pytest.approx(100 * k3_least_s(60_400_000, 2, 43)[0] / 0.002)


def test_readers_without_a_trace(record):
    record["device"] = None
    for name in ("k1_roofline_pct", "k3_roofline_pct", "device_idle_pct"):
        assert read(name, record) is None  # nothing to read: left out, never 0


def test_every_metric_has_a_reader():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics", f"{m['name']}.py")), m["name"]
