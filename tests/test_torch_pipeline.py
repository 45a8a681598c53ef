"""The port's index and call phases against malva_tpu's host path.

The port runs its device path on CPU tensors (the kernels' plain
versions); malva_tpu runs ``backend="host"``.  The VCF must be byte-
identical and so must the index state.
"""

import io
import os

import numpy as np
import pytest

import malva_tpu.pipeline as mp
from malva_tpu.utils.config import Config
from malva_tpu_torch import pipeline as tp
from fuzz_gen import gen_case

D = os.path.join(os.path.dirname(__file__), "data", "diploid")


def _diploid(bf_size, **kw):
    return Config(fasta_path=os.path.join(D, "ref.fa"), vcf_path=os.path.join(D, "vars.vcf"),
                  sample_path=os.path.join(D, "reads.fa"), bf_size=bf_size, **kw)


def _fuzz(tmp_path, bf_size, **kw):
    fa, vcf, reads = gen_case(str(tmp_path), seed=41, n_samples=5, ref_len=5000, n_var=80,
                              iupac_rate=0.01)
    return Config(fasta_path=fa, vcf_path=vcf, sample_path=reads, bf_size=bf_size, **kw)


def _assert_same_index(a, b):
    np.testing.assert_array_equal(a.bf.words, b.bf.words)
    np.testing.assert_array_equal(a.context_bf.words, b.context_bf.words)
    np.testing.assert_array_equal(a.bf.counts, b.bf.counts)
    assert a.ref_bf.kmers == b.ref_bf.kmers


def _run_both(cfg_host, cfg_port):
    ref_index = mp.build_index(cfg_host)
    index = tp.build_index(cfg_port, device="cpu")
    _assert_same_index(ref_index, index)
    want, got = io.StringIO(), io.StringIO()
    mp.call(cfg_host, ref_index, want)
    stats = tp.call(cfg_port, index, got, device="cpu")
    assert stats is not None and stats["rows"] > 0
    _assert_same_index(ref_index, index)
    assert got.getvalue() == want.getvalue()
    return got.getvalue()


@pytest.mark.parametrize("case", ["diploid", "fuzz"])
def test_device_path_on_cpu_matches_host(case, tmp_path):
    make = (lambda **kw: _diploid(1 << 20, **kw)) if case == "diploid" else (
        lambda **kw: _fuzz(tmp_path, 1 << 20, **kw))
    vcf = _run_both(make(backend="host"), make(backend="cuda"))
    assert vcf.count("\n") > 50


def test_spill_stream_matches_host(tmp_path):
    """The spill branch of call: buckets stream through the device step."""
    host = _diploid(1 << 20, backend="host", spill_dir=str(tmp_path / "h"))
    port = _diploid(1 << 20, backend="cuda", spill_dir=str(tmp_path / "p"))
    _run_both(host, port)


def test_kmc_dump_stream_matches_host(tmp_path):
    """The KMC-dump branch of call, with non-canonical and non-ACGT rows."""
    rng = np.random.default_rng(2)
    alpha = np.frombuffer(b"ACGTN", dtype=np.uint8)
    rows = alpha[rng.choice(5, size=(3000, 43), p=[0.2475] * 4 + [0.01])]
    dump = tmp_path / "dump.txt"
    dump.write_text("".join(f"{r.tobytes().decode()}\t{c}\n"
                            for r, c in zip(rows, rng.integers(2, 200, 3000))))
    host = _diploid(1 << 20, backend="host", from_kmc_dump=True)
    port = _diploid(1 << 20, backend="cuda", from_kmc_dump=True)
    host.sample_path = port.sample_path = str(dump)
    _run_both(host, port)


@pytest.mark.slow
def test_device_path_on_cpu_golden_b1():
    """At -b 1 the port's device path (CPU tensors) reproduces the
    oracle-made golden VCF."""
    cfg = _diploid(Config.bf_gb_to_bits(1), backend="cuda")
    index = tp.build_index(cfg, device="cpu")
    out = io.StringIO()
    tp.call(cfg, index, out, device="cpu")
    assert out.getvalue() == open(os.path.join(D, "golden.vcf")).read()


def test_host_backend_cli_matches_golden(tmp_path, capsys):
    """`malva-tpu-torch run --backend host` on the diploid fixture."""
    import shutil

    from malva_tpu_torch import cli

    for name in ("ref.fa", "vars.vcf", "reads.fa"):
        shutil.copy(os.path.join(D, name), tmp_path / name)
    args = ["run", "--backend", "host", "-b", "1",
            *(str(tmp_path / n) for n in ("ref.fa", "vars.vcf", "reads.fa"))]
    assert cli.main(args) == 0
    assert capsys.readouterr().out == open(os.path.join(D, "golden.vcf")).read()


def test_backend_resolution(monkeypatch):
    import torch

    from malva_tpu_torch import backend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert backend.resolve(Config(backend="host")) == "host"
    assert backend.resolve(Config(backend="auto", bf_size=1 << 33), 1 << 40, 1) == "host"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend.resolve(Config(backend="cuda"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert backend.resolve(Config(backend="auto", bf_size=1 << 33), 1 << 40, 1) == "cuda"
    assert backend.resolve(Config(backend="auto", bf_size=1 << 33), 10, 100) == "host"
    assert backend.resolve(Config(backend="auto", bf_size=3 << 20), 1 << 40, 1) == "host"
    with pytest.raises(ValueError):
        backend.resolve(Config(backend="cuda", bf_size=9 << 33))
    with pytest.raises(ValueError):
        backend.resolve(Config(backend="device"))
    assert backend.device_for(Config(backend="host", bf_size=1 << 20), device="cpu").type == "cpu"


def test_run_overlaps_counting_only_where_malva_tpu_does(monkeypatch, tmp_path):
    """`run` starts the overlapped counting producer as malva_tpu/cli.py:
    263-278 does: not for reads that route to the card, which are counted
    there; malva_tpu's _start_count_producer makes the other checks."""
    import torch

    from malva_tpu_torch import cli

    def producer(c):  # the decision `run` makes, without starting a process
        return cli._overlaps_counting(c) and cli._start_count_producer(c) is not None

    reads = tmp_path / "reads.fq"
    with open(reads, "wb") as f:
        f.truncate(1 << 27)  # sparse: above the overlap and device read floors
    small = tmp_path / "small.fq"
    small.write_bytes(b">r\nACGT\n")
    for name in ("MALVA_NO_OVERLAP", "MALVA_OVERLAP_MIN_BYTES"):
        monkeypatch.delenv(name, raising=False)

    def cfg(backend, path=reads, **kw):
        return Config(sample_path=str(path), bf_size=1 << 33, backend=backend, **kw)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert not cli._overlaps_counting(cfg("cuda"))
    assert not cli._overlaps_counting(cfg("auto"))
    assert cli._overlaps_counting(cfg("host"))
    assert not producer(cfg("host", from_kmc_dump=True))
    assert not producer(cfg("host", small))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli._overlaps_counting(cfg("auto"))  # no card: the host counts it
    monkeypatch.setenv("MALVA_NO_OVERLAP", "1")
    assert not producer(cfg("host"))


def test_profile_dir_writes_a_trace(tmp_path, capsys):
    """`run --profile-dir d` writes a torch.profiler trace into d; the VCF
    on stdout is still the golden one."""
    import json
    import shutil

    from malva_tpu_torch import cli

    for name in ("ref.fa", "vars.vcf", "reads.fa"):
        shutil.copy(os.path.join(D, name), tmp_path / name)
    prof = tmp_path / "prof"
    args = ["run", "--backend", "host", "-b", "1", "--profile-dir", str(prof),
            *(str(tmp_path / n) for n in ("ref.fa", "vars.vcf", "reads.fa"))]
    assert cli.main(args) == 0
    assert capsys.readouterr().out == open(os.path.join(D, "golden.vcf")).read()
    traces = sorted(prof.glob("*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
