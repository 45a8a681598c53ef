"""The comparison catches what it is there to catch: the control (the
reference in the program's place, counting in four bits where the
configuration counts in eight) and the program broken underneath the
timed path, each read as not correct.  A run with a card's look skipped
drives the port's host route, on tiny cells."""

import pytest

from h100bench import check, run
from h100bench.gen.cohort import make_cohort, rng_for
from h100bench.gen.reads import make_donor, pick_donors
from h100bench.reference.malva import CONTROL_CAP, Reference


@pytest.mark.parametrize("cell", ["chr_cell", "haploid_cell"])
def test_control_is_not_correct(cell, request, tmp_path):
    cfg, wl = request.getfixturevalue(cell)
    flags = run.genotyper_flags(cfg["flags"])
    co = make_cohort(cfg, 21, str(tmp_path))
    rs = make_donor(co, pick_donors(co, 1, rng_for(21, 1))[0], wl, rng_for(21, 2),
                    str(tmp_path / "d.fq.gz"))
    ref = Reference.build(co, flags.b << 33, flags.k, flags.r, flags.haploid, flags.verbose,
                          flags.c, flags.e)
    want = ref.vcf(ref.state(rs.reads))
    got = ref.vcf(ref.state(rs.reads, CONTROL_CAP))
    assert check.vcf_diff(got, want) > check.LIMITS["vcf_diff"]


def _run_broken(cell, monkeypatch, tmp_path):
    cfg, wl = cell
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return run.run_cell(wl, cfg, 99, 0.5, False, {"samples_per_min": "samples/min"},
                        backend="host")


def _state_unchanged(monkeypatch):
    """The call step returns the counters as they were."""
    import malva_tpu_torch.pipeline as p

    monkeypatch.setattr(p, "apply_sample_counts", lambda *a, **k: None)


def _half_the_reads(monkeypatch):
    """Every other read is left out of the count."""
    import malva_tpu_torch.count.counter as c

    batches = c.iter_read_batches
    monkeypatch.setattr(c, "iter_read_batches",
                        lambda *a, **k: (b[::2] for b in batches(*a, **k)))


def _answer_altered(monkeypatch):
    """One record's genotype is changed where the VCF line is made."""
    import malva_tpu_torch.pipeline as p

    fmt = p.format_variants

    def altered(*a, **k):
        lines = fmt(*a, **k)
        if lines:
            lines[0] = lines[0][:-1] + ("9" if lines[0][-1] != "9" else "8")
        return lines

    monkeypatch.setattr(p, "format_variants", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_reads, _answer_altered])
@pytest.mark.parametrize("cell", ["chr_cell", "haploid_cell"])
def test_fault_is_not_correct(fault, cell, request, monkeypatch, tmp_path):
    cell = request.getfixturevalue(cell)
    fault(monkeypatch)
    res = _run_broken(cell, monkeypatch, tmp_path)
    assert res["correct"] is False
    assert res["checks"]["vcf_diff"]["value"] > 0 and res["checks"]["index_diff"]["value"] == 0


def test_index_fault_is_not_correct(chr_cell, monkeypatch, tmp_path):
    """A key of the exact map dropped where the index is saved."""
    import malva_tpu_torch.pipeline as p

    state = p._index_state

    def dropped(index):
        st = state(index)
        st["kmap_keys"], st["kmap_vals"] = st["kmap_keys"][1:], st["kmap_vals"][1:]
        return st

    monkeypatch.setattr(p, "_index_state", dropped)
    res = _run_broken(chr_cell, monkeypatch, tmp_path)
    assert res["correct"] is False and res["checks"]["index_diff"]["value"] > 0


def test_control_script_reads_the_four_bit_control(haploid_cell, capsys, monkeypatch, tmp_path):
    """``control.py`` at a tiny size: the four-bit counts differ from the
    reference's on every checked donor."""
    import json

    from h100bench import control

    cfg, wl = haploid_cell
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(run, "load_cell", lambda name: ({}, wl, cfg))
    assert control.main(["--workload", wl["name"], "--seeds", "31"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["records"] == cfg["records"] and len(line["control_vcf_diff"]) == 2
    assert min(line["control_vcf_diff"]) > check.LIMITS["vcf_diff"]
