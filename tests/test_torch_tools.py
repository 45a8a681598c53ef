"""The port's two measurement tools on the CPU: the bounded-memory counting
demo (malva_tpu_torch/tools/demo_spill_wgs.py) against the JAX package's
tool (tools/demo_spill_wgs.py) and an independent numpy count of the same
reads, its split and the device sort-count's stats sink; and the gather
curve (malva_tpu_torch/tools/gather_vs_size.py) against numpy's take.
Tolerance zero throughout: keys, counts and sums are integers."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from malva_tpu_torch.count import device_count as tdc
from malva_tpu_torch.tools import demo_spill_wgs, gather_vs_size

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_KS = [43, 31]  # two key words, one
ROUTES = ["host", "cpu"]
CARD_KEYS = {"chunk_assembly_s", "upload_s", "k3_seq_pack_s", "sort_count_s", "read_back_s"}
CI, CS = 2, 255


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("reads") / "reads.fq")
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "make_reads.py"), path,
                    "--genome-mbp", "0.05", "--coverage", "30", "--error", "0.01", "--seed", "3"],
                   check=True, capture_output=True)
    return path


@pytest.fixture(scope="module")
def demo(reads, tmp_path_factory):
    """The port's demo, run once per (ref_k, route): its stdout lines."""
    runs = {}

    def run(ref_k: int, route: str) -> list[str]:
        if (ref_k, route) not in runs:
            spill = str(tmp_path_factory.mktemp("spill"))
            out = io.StringIO()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
                assert demo_spill_wgs.main([reads, "--ref-k", str(ref_k), "--spill", spill,
                                            "--device", route]) == 0
            runs[(ref_k, route)] = out.getvalue().splitlines()
        return runs[(ref_k, route)]

    return run


def _summary(lines: list[str]) -> dict:
    m = re.search(r"\[spill-demo\] kept_distinct=(\d+) kept_total=(\d+) checksum=([0-9a-f]{16})",
                  "\n".join(lines))
    assert m, lines
    return {"kept_distinct": int(m.group(1)), "kept_total": int(m.group(2)),
            "checksum": m.group(3)}


def _numpy_count(path: str, ref_k: int) -> dict:
    """Canonical ref_k-windows of the reads, counted with np.unique: the
    lesser of each window's 2-bit words and its reverse complement's."""
    with open(path, "rb") as f:
        seqs = f.read().split(b"\n")[1::4]
    assert len({len(s) for s in seqs}) == 1  # make_reads.py: fixed-length ACGT reads
    code = np.full(256, 255, dtype=np.uint8)
    code[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    codes = code[np.frombuffer(b"".join(seqs), np.uint8).reshape(len(seqs), -1)]
    assert (codes < 4).all()
    win = np.lib.stride_tricks.sliding_window_view(codes, ref_k, axis=1).reshape(-1, ref_k)

    def words(c: np.ndarray) -> np.ndarray:
        out = np.zeros((c.shape[0], (ref_k + 31) // 32), dtype=np.uint64)
        for i in range(ref_k):
            out[:, i // 32] |= c[:, i].astype(np.uint64) << np.uint64(2 * (31 - i % 32))
        return out

    fwd, rev = words(win), words(3 - win[:, ::-1])
    rev_less = np.zeros(fwd.shape[0], dtype=bool)
    for j in range(fwd.shape[1] - 1, -1, -1):
        rev_less = (rev[:, j] < fwd[:, j]) | ((rev[:, j] == fwd[:, j]) & rev_less)
    keys, counts = np.unique(np.where(rev_less[:, None], rev, fwd), axis=0, return_counts=True)
    keep = counts >= CI
    keys, counts = keys[keep], np.minimum(counts[keep], CS).astype(np.uint64)
    h = counts.copy()
    with np.errstate(over="ignore"):
        for j in range(keys.shape[1]):
            h ^= keys[:, j] * np.uint64(0x9E3779B97F4A7C15)
    return {"kept_distinct": int(keys.shape[0]), "kept_total": int(counts.sum()),
            "checksum": f"{int(np.bitwise_xor.reduce(h)):016x}"}


@pytest.mark.parametrize("ref_k", REF_KS)
def test_demo_matches_the_jax_tool(reads, demo, tmp_path, ref_k):
    """--device host and --device cpu give the JAX tool's checksum, kept
    distinct k-mers and kept total on the same reads."""
    p = subprocess.run([sys.executable, os.path.join(REPO, "tools", "demo_spill_wgs.py"), reads,
                        "--ref-k", str(ref_k), "--spill", str(tmp_path / "jax")],
                       env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True, text=True,
                       check=True)
    want = _summary(p.stdout.splitlines())
    assert want["kept_distinct"] > 1000
    for route in ROUTES:
        lines = demo(ref_k, route)
        assert _summary(lines) == want, route
        result = json.loads(lines[-1])
        assert {k: result[k] for k in want} == want, route
        assert result["device"] == route and result["ref_k"] == ref_k


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("ref_k", REF_KS)
def test_demo_matches_a_numpy_count(reads, demo, ref_k, route):
    result = json.loads(demo(ref_k, route)[-1])
    assert {k: result[k] for k in ("kept_distinct", "kept_total", "checksum")} == \
        _numpy_count(reads, ref_k)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("ref_k", REF_KS)
def test_demo_split_within_the_wall(reads, demo, ref_k, route):
    """The parts are non-negative and sum to at most the wall; only the
    device route has the pieces' parts; K3's wrapper launched nothing on
    the CPU."""
    result = json.loads(demo(ref_k, route)[-1])
    split = result["split_s"]
    assert all(v >= 0 for v in split.values()), split
    assert sum(v for k, v in split.items() if k != "unattributed_s") <= result["wall_s"]
    assert split["unattributed_s"] >= 0
    assert result["windows"] > 0 and result["segments"] >= 1 and result["spill_bytes"] > 0
    assert result["reads_bytes"] == os.path.getsize(reads)
    assert result["seq_pack_launches"] == 0 and "peak_device_gb" not in result
    assert 0 < result["peak_rss_setup_gb"] <= result["peak_rss_count_gb"] <= result["peak_rss_gb"]
    if route == "host":
        assert not CARD_KEYS & split.keys() and "host_count_s" in split
        assert result["pieces"] == 0
    else:
        assert CARD_KEYS <= split.keys() and "host_count_s" not in split
        assert result["pieces"] >= result["segments"]


@pytest.mark.parametrize("ref_k", [16, 43])
def test_stats_sink_leaves_the_sort_count_unchanged(ref_k):
    """device_seq_sorted_counts with a CountStats gives the same keys and
    counts as without, and records one piece in its four parts."""
    rng = np.random.default_rng(ref_k)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 5000)]
    seq[rng.integers(0, 5000, 40)] = np.frombuffer(b"N\xff", np.uint8)[rng.integers(0, 2, 40)]
    plain = tdc.device_seq_sorted_counts(tdc.make_seq_sort_count_step(ref_k, 8192, "cpu"), seq)
    stats = tdc.CountStats()
    got = tdc.device_seq_sorted_counts(tdc.make_seq_sort_count_step(ref_k, 8192, "cpu", stats),
                                       seq)
    assert plain[0].shape[0] > 100
    np.testing.assert_array_equal(got[0], plain[0])
    np.testing.assert_array_equal(got[1], plain[1])
    assert stats.pieces == 1
    parts = set(demo_spill_wgs.CARD_PARTS) | {"pieces"}
    assert set(stats.seconds) == parts and all(v >= 0 for v in stats.seconds.values())
    assert sum(stats.seconds[p] for p in demo_spill_wgs.CARD_PARTS) <= stats.seconds["pieces"]


@pytest.mark.parametrize("tool", ["demo_spill_wgs", "gather_vs_size"])
def test_cuda_without_a_card_exits_and_names_it(reads, tool):
    """The default device is the card; without one the tool stops, says
    so and prints no result: it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    argv = [reads] if tool == "demo_spill_wgs" else []
    p = subprocess.run([sys.executable, "-m", f"malva_tpu_torch.tools.{tool}", *argv],
                       cwd=REPO, capture_output=True, text=True)
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    assert p.stdout == ""


@pytest.mark.parametrize("max_log2_rows,sizes", [(12, [12]), (18, [17, 18])])
def test_gather_tool_on_cpu(capsys, max_log2_rows, sizes):
    """A line per size and route; each line's sum is numpy's take over
    the same generator's table and indices, read as 64-bit words and
    summed mod 2^64."""
    assert gather_vs_size.main(["--device", "cpu", "--max-log2-rows", str(max_log2_rows)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(r["rows"] * r["row_bytes"], r["route"]) for r in lines] == \
        [(8 << n, route) for n in sizes for route in gather_vs_size.ROUTES]
    for r, (n, route) in zip(lines, [(n, route) for n in sizes for route in gather_vs_size.ROUTES]):
        table, idx = gather_vs_size.inputs(n, route, torch.device("cpu"))
        want = np.take(table.numpy(), idx[1:].numpy()).view(np.uint64)
        assert r["sum"] % (1 << 64) == int(want.sum(dtype=np.uint64))
        assert r["bytes"] == 8 << n and r["M_rows_per_s"] > 0
        assert r["ms_per_batch"] > 0 and r["sum_ms_per_batch"] > 0
        assert r["batch"] == gather_vs_size.BATCH and r["device"] == "cpu"
