"""The port never imports jax, nor any module of the JAX package.

Checked in a subprocess, since this test process has jax and malva_tpu
loaded already (tests/conftest.py).
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
D = REPO / "tests" / "data" / "diploid"

SCRIPT = r"""
import io, shutil, sys
from malva_tpu_torch import cli, pipeline
from malva_tpu_torch.utils.config import Config

work = sys.argv[1]
inputs = [f"{work}/{n}" for n in ("ref.fa", "vars.vcf", "reads.fa")]
out = io.StringIO()
assert cli.main(["run", "--backend", "host", "-b", "1", *inputs], out=out) == 0
assert out.getvalue() == open(sys.argv[2]).read(), "host run differs from golden"

cfg = Config(fasta_path=inputs[0], vcf_path=inputs[1], sample_path=inputs[2],
             bf_size=1 << 20, backend="cuda")
index = pipeline.build_index(cfg, device="cpu")
out = io.StringIO()
stats = pipeline.call(cfg, index, out, device="cpu")
assert stats["rows"] > 0 and out.getvalue().count("\n") > 50

# device counting, batch and the genotype model, all on CPU tensors
import torch
from malva_tpu_torch.count.counter import count_reads_kmers
from malva_tpu_torch.count.spill import count_reads_kmers_spill
from malva_tpu_torch.models.genotype import make_genotype_fn

keys, counts = count_reads_kmers(inputs[2], 43, device="cpu", chunk_kmers=4096)
assert keys.shape[0] > 0
assert sum(k.shape[0] for k, _ in count_reads_kmers_spill(
    inputs[2], 43, f"{work}/spill", device="cpu", chunk_kmers=4096)) == keys.shape[0]
outs = [io.StringIO(), io.StringIO()]
pipeline.call_batch(cfg, index, [inputs[2], inputs[2]], outs, device="cpu")
assert outs[0].getvalue() == outs[1].getvalue() == out.getvalue()
g1, g2, gq = make_genotype_fn(3, False, 0.001, 200, "cpu")(
    torch.tensor([[10, 12, 0]], dtype=torch.int32), torch.tensor([[0.5, 0.5, 0.0]]),
    torch.tensor([2], dtype=torch.int32))
assert (int(g1), int(g2)) == (0, 1)

# the mesh path on four virtual CPU shards, and graft_entry's entry points
from malva_tpu_torch.graft_entry import dryrun_multichip, entry

mesh = [torch.device("cpu")] * 4
index = pipeline.build_index(cfg, mesh=mesh)
out = io.StringIO()
stats = pipeline.call(cfg, index, out, mesh=mesh)
assert stats["shards"] == 4 and out.getvalue() == open(sys.argv[2]).read()
dryrun_multichip(4, mesh)
step, args = entry()
step(*args)

# the all-gather design on the same mesh, and the two measurement tools
from malva_tpu_torch import bench
from malva_tpu_torch.parallel.sharded_index import apply_sample_counts_sharded
from malva_tpu_torch.tools import scaling_mesh

pipeline._reset_counters(index)
assert apply_sample_counts_sharded(index, keys, counts, cfg, mesh, routed=False)["rows"] > 0
scaling_mesh.main(["--device", "cpu", "--log2-bits", "18", "--batch", "1024", "--shards", "1,2"])
if shutil.which("g++"):
    bench.main(device="cpu", log2_bits=18, map_keys=500, batch=512, iters=1, machine=False)

loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "malva_tpu"))
assert not loaded, loaded
print("NO-JAX-OK")
"""


def test_port_runs_without_importing_jax(tmp_path):
    for name in ("ref.fa", "vars.vcf", "reads.fa"):
        shutil.copy(D / name, tmp_path / name)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path), str(D / "golden.vcf")],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO-JAX-OK" in res.stdout


def _port_files() -> list[Path]:
    files = sorted((REPO / "malva_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 8
    return files


JAX_IMPORT = re.compile(r"^\s*(import jax|from jax)\b", re.M)
MALVA_TPU_IMPORT = re.compile(r"^\s*(from|import)\s+malva_tpu(\.|\s|$)", re.M)


def test_no_port_file_imports_jax():
    offenders = [str(f.relative_to(REPO)) for f in _port_files()
                 if JAX_IMPORT.search(f.read_text())]
    assert not offenders


def test_no_port_file_imports_malva_tpu():
    """The port keeps its own copy of every host layer it runs."""
    offenders = [str(f.relative_to(REPO)) for f in _port_files()
                 if MALVA_TPU_IMPORT.search(f.read_text())]
    assert not offenders


def test_malva_tpu_import_pattern():
    for line in ("from malva_tpu.ops.seq import canonical", "import malva_tpu",
                 "  from malva_tpu import cli", "import malva_tpu.pipeline as mp"):
        assert MALVA_TPU_IMPORT.search(line), line
    for line in ("from malva_tpu_torch.ops import kernels", "import malva_tpu_torch",
                 "from .pipeline import Index", "# from malva_tpu import cli is gone"):
        assert not MALVA_TPU_IMPORT.search(line), line
