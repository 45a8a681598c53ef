"""The plain reference against the port's host route: the same index and
the same VCF, on tiny seeds; its XXH3 against the test vectors."""

import os

import numpy as np
import pytest

from h100bench import run
from h100bench.reference.xxh3 import xxh3_64

VECTORS = os.path.join(run.ROOT, "tests", "data", "xxh3_vectors.npz")


def test_xxh3_vectors():
    z = np.load(VECTORS)
    n = 0
    for L in range(17, 129):
        if f"in_{L}" in z.files:
            assert np.array_equal(xxh3_64(z[f"in_{L}"]), z[f"h_{L}"]), L
            n += 1
    assert n > 40


@pytest.mark.parametrize("cell,seed", [("chr_cell", 3), ("chr_cell", 2**35 + 17),
                                       ("haploid_cell", 5), ("haploid_cell", 2**40 + 21)])
def test_reference_agrees_with_the_host_route(cell, seed, request, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cfg, wl = request.getfixturevalue(cell)
    res = run.run_cell(wl, cfg, seed, 0.5, False, {"samples_per_min": "samples/min"},
                       backend="host")
    assert res["checks"] == {"index_diff": {"value": 0, "limit": 0},
                             "vcf_diff": {"value": 0, "limit": 0}}
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
