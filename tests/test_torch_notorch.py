"""The port's host paths run without torch, as malva_tpu's run without jax.

Every module on a host path imports with torch refused, ``run``,
``index``/``call`` and ``batch`` with ``--backend host`` write the golden
VCF with torch refused, the overlapped ``run``'s spill producer counts
without it and refuses it, and the spill demo's host route gives the
checksum of its torch route without loading torch.  Each check runs in a
subprocess whose first import finder refuses ``torch`` (this test
process has torch loaded already).  ``--backend cuda`` without a card
still raises.
"""

import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from malva_tpu_torch.count import spill

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = os.path.join(REPO, "tests", "data", "diploid")
GOLDEN = os.path.join(D, "golden.vcf")

# the first import finder of each subprocess: torch's import raises
NO_TORCH = r"""
import sys

class _NoTorch:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "torch":
            raise ImportError(f"torch is refused here: {name}")
        return None

sys.meta_path.insert(0, _NoTorch())
"""

# a CLI command with torch refused; torch must not be loaded at its end
CLI = NO_TORCH + r"""
from malva_tpu_torch import cli

rc = cli.main(sys.argv[1:])
assert "torch" not in sys.modules
sys.exit(rc)
"""

HOST_MODULES = [
    "io.fasta", "io.vcf", "io.bcf", "io.kmc", "io.malvax", "variants.blocks",
    "variants.variant", "utils.config", "utils.errors", "utils.native", "utils.timing",
    "ops.seq", "ops.xxh3", "index.bloom_filter", "index.kmap", "models.genotype_host",
    "count.counter", "count.spill", "backend", "pipeline", "cli", "run_distributed",
]


def _python(code: str, *args, env=None, **kw) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    return subprocess.run([sys.executable, "-c", code, *args], env=env, capture_output=True,
                          text=True, timeout=600, **kw)


def _inputs(work) -> list[str]:
    """Private copies of the diploid inputs (an index is saved beside the VCF)."""
    return [shutil.copy(os.path.join(D, n), os.path.join(work, n))
            for n in ("ref.fa", "vars.vcf", "reads.fa")]


def _golden() -> str:
    with open(GOLDEN) as f:
        return f.read()


@pytest.mark.parametrize("module", HOST_MODULES)
def test_host_module_imports_without_torch(module):
    res = _python(NO_TORCH + f"import malva_tpu_torch.{module}\n"
                  "assert 'torch' not in sys.modules\nprint('OK')")
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "OK"


def _run(work, env):
    res = _python(CLI, "run", "--backend", "host", "-b", "1", *_inputs(work), env=env)
    return res, [res.stdout]


def _index_call(work, env):
    inputs = _inputs(work)
    res = _python(CLI, "index", "--backend", "host", "-b", "1", *inputs, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    res = _python(CLI, "call", "--backend", "host", "-b", "1", *inputs, env=env)
    return res, [res.stdout]


def _batch(work, env):
    fa, vcf, reads = _inputs(work)
    copy = shutil.copy(reads, os.path.join(work, "again.fa"))
    out = os.path.join(work, "out")
    res = _python(CLI, "batch", "--backend", "host", "-b", "1", "-o", out, fa, vcf, reads, copy,
                  env=env)
    vcfs = []
    for name in ("reads.malva.vcf", "again.malva.vcf"):
        with open(os.path.join(out, name)) as f:
            vcfs.append(f.read())
    return res, vcfs


# command -> (how it runs, its environment)
COMMANDS = {
    "run": (_run, {"MALVA_NO_OVERLAP": "1"}),
    "run with the spill producer": (_run, {"MALVA_NO_OVERLAP": "",
                                           "MALVA_OVERLAP_MIN_BYTES": "0"}),
    "index then call": (_index_call, {}),
    "batch": (_batch, {}),
}


@pytest.mark.parametrize("command", list(COMMANDS))
def test_host_backend_writes_golden_without_torch(tmp_path, command):
    """Byte for byte the golden VCF, torch refused in the process (and, in
    the overlapped ``run``, in its producer child, whose last line goes
    to the stderr it shares with the parent)."""
    how, env = COMMANDS[command]
    res, vcfs = how(str(tmp_path), env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert all(v == _golden() for v in vcfs)
    if command == "run with the spill producer":
        assert "counting overlapped with index build" in res.stderr
        assert "producer: peak RSS" in res.stderr


PRODUCER = NO_TORCH + r"""
from malva_tpu_torch.count import spill

assert spill._produce_main(sys.argv[1:]) == 0
print(sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "malva_tpu")))
"""


def test_producer_child_counts_the_in_process_kmers(tmp_path):
    """The producer child, with torch refused before it starts, runs to rc
    0, reports its peak and start-up, and leaves a spill whose merge is
    the in-process counter's k-mers and counts."""
    from malva_tpu_torch.count.counter import count_reads_kmers

    reads = os.path.join(D, "reads.fa")
    spill_dir = str(tmp_path / "spill")
    res = _python(PRODUCER, reads, "43", spill_dir)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"
    line = [ln for ln in res.stderr.splitlines() if "producer: peak RSS" in ln]
    assert len(line) == 1 and "start-up" in line[0]
    log = io.StringIO()
    merged = list(spill.count_reads_kmers_spill(reads, 43, spill_dir, log=log))
    assert "spill complete: skipping production" in log.getvalue()
    keys = np.concatenate([k for k, _ in merged])
    counts = np.concatenate([c for _, c in merged])
    order = np.lexsort(keys.T[::-1])
    want_keys, want_counts = count_reads_kmers(reads, 43, log=io.StringIO(), return_packed=True)
    assert want_keys.shape[0] > 1000
    np.testing.assert_array_equal(keys[order], want_keys)
    np.testing.assert_array_equal(counts[order], want_counts)


@pytest.mark.parametrize("name", ["torch", "torch.cuda", "jax", "malva_tpu.ops"])
def test_producer_guard_refuses(name):
    with pytest.raises(ImportError, match="spill producer must not import"):
        spill._PortOnly().find_spec(name)
    assert spill._PortOnly().find_spec("numpy") is None


def test_producer_guard_raises_on_import_torch():
    """Behind the guard ``import torch`` raises; a producer started in a
    process that has torch loaded already fails before it counts."""
    res = _python(r"""
import sys
from malva_tpu_torch.count import spill
sys.meta_path.insert(0, spill._PortOnly())
try:
    import torch
except ImportError as e:
    print("refused:", e)
""")
    assert res.returncode == 0, res.stderr[-2000:]
    assert "refused: the spill producer must not import torch" in res.stdout
    res = _python("import sys, torch\nfrom malva_tpu_torch.count import spill\n"
                  "spill._produce_main(sys.argv[1:])", os.path.join(D, "reads.fa"), "43",
                  os.devnull)
    assert res.returncode != 0 and "spill producer must not import torch" in res.stderr


DEMO = r"""
import sys
from malva_tpu_torch.tools import demo_spill_wgs

assert demo_spill_wgs.main(sys.argv[1:]) == 0
"""


@pytest.fixture(scope="module")
def demo_reads(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("reads") / "reads.fq")
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "make_reads.py"), path,
                    "--genome-mbp", "0.05", "--coverage", "30", "--error", "0.01", "--seed", "5"],
                   check=True, capture_output=True)
    return path


@pytest.mark.parametrize("ref_k", [43, 31])
def test_spill_demo_host_route_without_torch(demo_reads, tmp_path, ref_k):
    """``--device host`` with torch refused gives the checksum of
    ``--device cpu`` (torch's CPU and the plain K3), its set-up peaks
    under 0.3 GB (VmHWM), and peak >= count >= set-up."""
    runs = {}
    for route in ("host", "cpu"):
        argv = [demo_reads, "--ref-k", str(ref_k), "--spill", str(tmp_path / route),
                "--device", route]
        code = (NO_TORCH + DEMO + 'assert "torch" not in sys.modules\n' if route == "host"
                else DEMO)
        res = _python(code, *argv)
        assert res.returncode == 0, res.stderr[-2000:]
        runs[route] = json.loads(res.stdout.splitlines()[-1])
    host, cpu = runs["host"], runs["cpu"]
    assert host["kept_distinct"] > 1000
    for key in ("checksum", "kept_distinct", "kept_total", "windows"):
        assert host[key] == cpu[key], key
    assert 0 < host["peak_rss_setup_gb"] < 0.3
    assert host["peak_rss_gb"] >= host["peak_rss_count_gb"] >= host["peak_rss_setup_gb"]
    assert list(host["rss_setup_split_gb"]) == ["host_library"]
    assert list(cpu["rss_setup_split_gb"]) == ["import_torch", "host_library"]


def test_cuda_backend_without_a_card_still_raises(tmp_path):
    """The lazy imports leave ``--backend cuda`` as it was: without a card
    it raises and writes no VCF; it never carries on on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = _python("import sys\nfrom malva_tpu_torch import cli\nsys.exit(cli.main(sys.argv[1:]))",
                  "run", "--backend", "cuda", "-b", "1", *_inputs(str(tmp_path)),
                  env={"MALVA_NO_OVERLAP": "1"})
    assert res.returncode != 0
    assert "--backend cuda: no CUDA device is available" in res.stderr
    assert "#CHROM" not in res.stdout
