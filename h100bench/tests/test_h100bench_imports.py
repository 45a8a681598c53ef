"""Nothing of the benchmark imports jax or the JAX package, the reference
imports nothing of the program, and the run's own check compares whole
top-level names."""

import ast
import os
import sys

import pytest

from h100bench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "malva_tpu"}


def sources():
    for d, _, files in os.walk(run.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not set(top_imports(path)) & FORBIDDEN, path


def test_reference_and_yardstick_import_nothing_of_the_program():
    yardstick = [p for p in sources() if os.sep + "tests" + os.sep not in p
                 and not p.endswith(os.sep + "run.py")]
    for path in yardstick:
        assert "malva_tpu_torch" not in set(top_imports(path)), path


@pytest.mark.parametrize("name,bad", [
    ("malva_tpu_torch", False), ("malva_tpu_torch.cli", False), ("jax_like", False),
    ("flaxen", False), ("malva_tpu", True), ("malva_tpu.ops.bloom", True), ("jax", True),
    ("jaxlib.xla_client", True), ("flax.linen", True)])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, name, bad):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name.split(".")[0] in run.forbidden_modules()) == bad
