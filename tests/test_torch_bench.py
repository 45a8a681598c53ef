"""The port's bench (malva_tpu_torch/bench.py), its C++ baseline and the
shard-scaling tool (malva_tpu_torch/tools/scaling_mesh.py), on the CPU at
tiny sizes: the baseline's XXH3 shim against the port's XXH3 (bit for
bit), the baseline's output, and both tools end to end with the kernels'
plain versions."""

import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from malva_tpu_torch import bench
from malva_tpu_torch.ops.xxh3 import xxh3_64

BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "baseline_single_thread",
              "baseline_machine", "vs_machine", "baseline_hash")


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = tmp_path_factory.mktemp("shim") / "xxh3_shim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{bench.CSRC}", "-o",
                    str(so), str(bench.CSRC / "xxh3_shim.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.XXH3_64bits.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.XXH3_64bits.restype = ctypes.c_uint64
    return so, lib


@pytest.mark.parametrize("length", [35, 43])
def test_shim_xxh3_matches_port(shim, length):
    """XXH3_64bits of the baseline's shim == ops/xxh3.py on seeded rows of
    the two lengths it takes (ACGT rows and arbitrary bytes)."""
    _, lib = shim
    rng = np.random.default_rng(length)
    rows = np.concatenate([
        np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, size=(200, length))],
        rng.integers(0, 256, size=(200, length), dtype=np.uint64).astype(np.uint8)])
    got = np.array([lib.XXH3_64bits(r.ctypes.data, length) for r in rows], dtype=np.uint64)
    np.testing.assert_array_equal(got, xxh3_64(rows))


def test_shim_refuses_other_lengths(shim):
    """Any length but 35 and 43 aborts: the shim is no general XXH3."""
    so, _ = shim
    code = (f"import ctypes; lib = ctypes.CDLL({str(so)!r}); "
            "lib.XXH3_64bits.argtypes = [ctypes.c_char_p, ctypes.c_size_t]; "
            "lib.XXH3_64bits(b'A' * 36, 36)")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert p.returncode != 0 and "only 35 and 43" in p.stderr


def test_baseline_prints_its_rate():
    """The C++ replica, built into build/bench/ from the package's sources,
    runs at a tiny size and prints kmers_per_sec=."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    exe = bench.baseline_exe()
    out = subprocess.run(bench.baseline_argv(exe, 20, 6, 2000), check=True,
                         capture_output=True, text=True).stdout
    assert out.startswith("kmers_per_sec=") and bench._rate(out) > 0


def test_bench_main_on_cpu_prints_bench_keys(capsys):
    """bench.main on the CPU at 2^20 bits and a 1000-key map: one JSON line
    with bench.py's keys and the baseline's hash, the device named."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    got = bench.main(device="cpu", log2_bits=20, map_keys=1000, batch=2048, iters=2,
                     machine=False)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    line = json.loads(lines[-1])
    assert line == json.loads(json.dumps(got))
    assert all(key in line for key in BENCH_KEYS)
    assert line["metric"] == "call_kmers_queried_per_sec_per_chip_wgs"
    assert line["device"] == "cpu" and line["card"] is None and len(line["repeats"]) == 3
    assert line["value"] > 0 and line["baseline_single_thread"] > 0
    # the headline is all lanes over all wall time, not one repeat's rate
    assert line["value"] == pytest.approx(3 * line["lanes_per_repeat"] / sum(line["wall_s"]))
    assert line["baseline_machine"] == 0.0 and line["baseline_hash"].endswith("xxh3.cuh")
    assert 0.01 < line["density"] < 0.02  # 2^-6


def test_scaling_tool_on_cpu_runs_both_designs():
    """python -m malva_tpu_torch.tools.scaling_mesh --device cpu at D = 1,
    2: both designs, each leaving the same written-back state."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-m", "malva_tpu_torch.tools.scaling_mesh", "--device",
                        "cpu", "--log2-bits", "20", "--batch", "2048", "--shards", "1,2"],
                       cwd=repo, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["device"].startswith("cpu") and out["iters"] == 6
    assert sorted((r["design"], r["shards"]) for r in out["runs"]) == [
        ("gather", 1), ("gather", 2), ("routed", 1), ("routed", 2)]
    assert set(out["speedup_vs_d1"]) == {"routed", "gather"}
    assert "gather D=2 (virtual)" in p.stderr and "K5" in p.stderr
