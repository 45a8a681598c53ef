"""The port never imports jax.

Checked in a subprocess, since this test process has jax loaded already
(tests/conftest.py).
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
import io, sys
from malva_tpu.utils.config import Config
from malva_tpu_torch import cli, pipeline

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

loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
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


def test_no_port_file_imports_jax():
    files = sorted((REPO / "malva_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 8
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert not offenders
