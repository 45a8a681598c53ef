"""The port's multi-process run on torch.distributed (gloo), on the CPU.

Mirrors tests/test_distributed.py:179-193 (here on the diploid fixture,
whose golden.vcf is in the repo), tests/test_distributed_units.py and
tests/test_sharded.py:94.  Each run spawns local processes with a
127.0.0.1 coordinator on a free port; splitting the reads across
processes does not change the global k-mer multiset, so rank 0's VCF must
equal the golden one byte for byte.  The processes run with
``PYTHONPROFILEIMPORTTIME``, so their stderr shows every module they
import, and none may be jax.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

from malva_tpu.utils.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = os.path.join(REPO, "tests", "data", "diploid")
JAX_IMPORT = re.compile(r"^import time:.*\|\s+jax(\.|$)", re.M)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """tests/data/diploid/reads.fa split into four read files."""
    d = tmp_path_factory.mktemp("torch_dist")
    lines = open(os.path.join(D, "reads.fa")).read().splitlines(keepends=True)
    recs = [lines[i : i + 2] for i in range(0, len(lines), 2)]
    paths = []
    for part in range(4):
        paths.append(str(d / f"reads{part}.fa"))
        with open(paths[-1], "w") as f:
            for r in recs[part::4]:
                f.writelines(r)
    return paths


def _args(port, n_procs, pid, out, reads, extra=()):
    return [sys.executable, "-m", "malva_tpu_torch.run_distributed",
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n_procs),
            "--process-id", str(pid), "--out", str(out), "-b", "1", *extra,
            os.path.join(D, "ref.fa"), os.path.join(D, "vars.vcf"), *reads]


def _env(importtime=False):
    env = dict(os.environ, PYTHONPATH=REPO)
    if importtime:
        env["PYTHONPROFILEIMPORTTIME"] = "1"
    return env


@pytest.mark.parametrize("n_procs,spill", [(2, False), (2, True), (4, False), (4, True)])
def test_multi_process_run_matches_golden(reads, tmp_path, n_procs, spill):
    port = _free_port()
    out = tmp_path / "out.vcf"
    procs = []
    for pid in range(n_procs):
        extra = ["--timeout", "240"]
        if spill:
            extra += ["--spill-dir", str(tmp_path / f"spill{pid}")]
        # stderr to files: a full pipe would stall one process mid-collective
        with open(tmp_path / f"err{pid}.txt", "w") as err:
            procs.append(subprocess.Popen(_args(port, n_procs, pid, out, reads, extra),
                                          env=_env(importtime=True), stdout=subprocess.DEVNULL,
                                          stderr=err))
    for p in procs:
        p.wait(timeout=300)
    errs = [(tmp_path / f"err{pid}.txt").read_text() for pid in range(n_procs)]
    assert all(p.returncode == 0 for p in procs), [e[-3000:] for e in errs]
    assert out.read_text() == open(os.path.join(D, "golden.vcf")).read()
    for err in errs:
        ex = [ln for ln in err.splitlines() if "exchange" in ln]
        assert ex and "all_to_all" in ex[0] and "fallback" not in ex[0], ex
        assert "rows sent" in ex[0]
        assert "import time:" in err and not JAX_IMPORT.search(err)
    if spill:
        assert all(os.listdir(tmp_path / f"spill{pid}") for pid in range(n_procs))


def test_mismatched_topology_fails_with_one_error_line(reads, tmp_path):
    """Processes told different world sizes must not hang: each that fails
    does so with one ERROR: line, within its --timeout."""
    port = _free_port()
    out = tmp_path / "mismatch.vcf"
    procs = []
    for n, pid in ((2, 0), (3, 1)):
        with open(tmp_path / f"err{pid}.txt", "w") as err:
            procs.append(subprocess.Popen(_args(port, n, pid, out, reads, ("--timeout", "8")),
                                          env=_env(), stdout=subprocess.DEVNULL, stderr=err))
    for p in procs:
        p.wait(timeout=90)
    results = [(p.returncode, (tmp_path / f"err{pid}.txt").read_text())
               for p, pid in zip(procs, (0, 1))]
    assert any(rc != 0 for rc, _ in results), results
    for rc, err in results:
        if rc != 0:
            lines = [ln for ln in err.splitlines() if ln.startswith("ERROR:")]
            assert len(lines) == 1, err[-2000:]


# A process that runs main with its set-up patched (CASE, TIMEOUT), then
# stays alive past every watchdog, as a slow interpreter teardown would.
# The modules main imports are imported first, so that main reaches its
# set-up at once and only the patched calls decide what happens when.
WATCHDOG_DRIVER = r"""
import sys, time
import torch.distributed as dist
from malva_tpu_torch import pipeline, run_distributed as rd
from malva_tpu_torch.parallel import distributed

case, timeout, args = sys.argv[1], float(sys.argv[2]), sys.argv[3:]

def init_fails(*a, **k):
    raise RuntimeError("no peer answered")

def watchdog_first(*a, **k):
    while not rd._spoken.locked():  # a watchdog has claimed the line
        time.sleep(0.001)
    raise RuntimeError("no peer answered")

def raise_then_slow_print(*a, **k):
    real = rd._error
    rd._error = lambda msg: (real(msg), time.sleep(timeout * 2))  # the watchdogs fall due
    raise RuntimeError("no peer answered")

def run_fails(cfg):
    raise dist.DistError("peer lost")

if case == "run":
    distributed.initialize = lambda *a, **k: None
    distributed.build_index_distributed = run_fails
else:
    distributed.initialize = {"init": init_fails, "watchdog first": watchdog_first,
                              "raise first": raise_then_slow_print}[case]
rc = rd.main(args + ["--timeout", str(timeout)])
time.sleep(timeout * 1.5)
sys.exit(rc)
"""


@pytest.mark.parametrize("case", ["init", "run", "watchdog first", "raise first"])
def test_one_error_line_whatever_fires(tmp_path, case):
    """Exactly one ERROR: line and exit code 1, when main has printed its
    error and the watchdogs fall due while the process lives on (init or
    run failed), when a watchdog speaks before initialize raises, and
    when the watchdogs fall due while the raise's line is printed."""
    args = _args(0, 2, 0, tmp_path / "out.vcf", [os.path.join(D, "reads.fa")])[3:]
    p = subprocess.run([sys.executable, "-c", WATCHDOG_DRIVER, case, "2", *args], env=_env(),
                       stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, timeout=120)
    lines = [ln for ln in p.stderr.splitlines() if ln.startswith("ERROR:")]
    assert p.returncode == 1 and len(lines) == 1, p.stderr[-2000:]
    want = {"init": "distributed init failed", "run": "distributed run failed",
            "watchdog first": "distributed ", "raise first": "distributed init failed"}[case]
    assert lines[0].startswith(f"ERROR: {want}"), lines
    if case == "watchdog first":
        assert "exceeded" in lines[0], lines


def test_count_distributed_single_process_matches_counter(tmp_path):
    """With no process group one process owns every range: the distinct
    k-mers and counts are the counter's (test_sharded.py:94)."""
    from malva_tpu.ops.seq import unpack_2bit

    from malva_tpu_torch.count.counter import count_reads_kmers
    from malva_tpu_torch.parallel.distributed import count_distributed, world

    assert world() == (0, 1)
    rng = np.random.default_rng(12)
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=500).tobytes()
    fa = tmp_path / "r.fa"
    with open(fa, "wb") as f:
        for i in range(30):
            s = int(rng.integers(0, 400))
            f.write(b">r%d\n%s\n" % (i, base[s : s + 80]))
    plain_k, plain_c = count_reads_kmers(str(fa), 13)
    for spill in (None, str(tmp_path / "spill")):
        dist_k, dist_c = count_distributed([str(fa)], Config(ref_k=13), spill_dir=spill)
        np.testing.assert_array_equal(unpack_2bit(dist_k, 13), plain_k)
        np.testing.assert_array_equal(dist_c, plain_c)


def test_merged_kmap_single_process_order():
    """The union is batch-ascending and first-occurrence-stable
    (test_distributed_units.py:74)."""
    from malva_tpu_torch.parallel.distributed import _merged_kmap

    k1 = [b"AAA", b"CCC"]
    k3 = [b"CCC", b"GGG", b"TT"]
    my = [(3, np.array([len(k) for k in k3], np.int32), b"".join(k3)),
          (1, np.array([len(k) for k in k1], np.int32), b"".join(k1))]
    km = _merged_kmap(my)
    assert list(km.kmers) == [b"AAA", b"CCC", b"GGG", b"TT"]
    assert all(v == 0 for v in km.kmers.values())
    assert list(_merged_kmap([]).kmers) == []


def test_merged_kmap_matches_jax_on_batches():
    """The port's key union equals JAX's on per-batch keys of the diploid
    VCF, NUL-truncated and mixed-length keys included."""
    from malva_tpu.io.fasta import load_reference
    from malva_tpu.parallel.distributed import _batch_ref_keys
    from malva_tpu.parallel.distributed import _merged_kmap as jax_merged
    from malva_tpu.pipeline import _iter_extract_batches

    from malva_tpu_torch.parallel.distributed import _merged_kmap

    cfg = Config(fasta_path=os.path.join(D, "ref.fa"), vcf_path=os.path.join(D, "vars.vcf"),
                 bf_size=1 << 20)
    refs = load_reference(cfg.fasta_path, cfg.strip_chr)
    my = []
    for bi, flat in _iter_extract_batches(cfg, refs, keep_absent=False, owned=lambda b: True):
        lens, data = _batch_ref_keys(flat)
        if lens.shape[0]:
            my.append((bi, lens, data))
    my.append((len(my) + 5, np.array([11, 13], np.int32), b"TTTTTTTTTTA" + b"ACGTACGTACGTA"))
    assert list(_merged_kmap(my).kmers) == list(jax_merged(my).kmers)
    assert len(_merged_kmap(my).kmers) > 100
