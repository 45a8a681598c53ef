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
    """The SARS-CoV-2 panel's configuration and its traffic (kept beside
    the benchmark, not yet one of its cells), cut to a size a test run
    holds: 6,000 bp with 3,000 records (the panel's density, a record per
    2 bp, so blocks chain over the whole genome), 400 genomes of 48
    lineages, two donors at 40x."""
    from h100bench import run

    cfg = run.load_json(run.HERE, "configs", "sarscov2-panel.json")
    cfg.update({"length_bp": 6000, "records": 3000, "samples": 400})
    cfg["lineages"] = dict(cfg["lineages"], n_lineages=48)
    wl = run.load_json(run.HERE, "workloads", "sarscov2-panel.call-200x.json")
    wl.update({"depth": 40, "donors": 2, "checked_samples": 2})
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
