"""The benchmark's own tests: ``python -m pytest h100bench/tests -q`` from
the repository's root.  Tests marked ``cuda`` run a cell on a card and
skip without one (``-m cuda`` runs them alone, on the card's machine)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_chr() -> tuple[dict, dict]:
    """The 1000 Genomes configuration and its cell, cut to a size a test
    run holds (60 kbp, 200 samples, two donors at 10x)."""
    from h100bench import run

    cfg = run.load_json(run.HERE, "configs", "chr20-1kgp3.json")
    cfg.update({"length_bp": 60000, "samples": 200,
                "populations": {"AFR": 60, "EUR": 80, "SAS": 60}})
    wl = run.load_json(run.HERE, "workloads", "chr20-1kgp3.call-30x.json")
    wl.update({"depth": 10, "donors": 2})
    return cfg, wl


def tiny_haploid() -> tuple[dict, dict]:
    """A haploid panel shaped like upstream MALVA's haploid example (56
    columns, an AF key of its own, `-1`), at -b 1 with 3,000 records and
    two donors at 40x: the reference's and the generator's haploid paths,
    which no cell drives yet."""
    cfg = {"name": "haploid-panel", "contig": "panel", "length_bp": 6000,
           "records": 3000, "samples": 56, "ploidy": 1, "snp_share": 0.93,
           "multiallelic_share": 0.05, "indel_max_len": 10, "af_from_columns": False,
           "af_min": 1e-05, "flags": ["-1", "-k", "35", "-r", "43", "-b", "1", "-f", "AF", "-v"]}
    wl = {"name": "haploid-panel.call-40x", "config": "haploid-panel", "job": "call",
          "depth": 40, "read_length": 150, "error_rate": 0.001, "donors": 2,
          "checked_samples": 2}
    return cfg, wl


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.fixture
def chr_cell():
    return tiny_chr()


@pytest.fixture
def haploid_cell():
    return tiny_haploid()
