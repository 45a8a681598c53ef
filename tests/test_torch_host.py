"""The port's own copy of the host layers against malva_tpu's.

The port keeps its own copy of the jax-free host modules (I/O, variants,
the Bloom filter and exact map, the host counter and spill store, the
host genotype model, the pipeline's host half, the CLI) and builds the
native host library itself.  Here both packages run on the same seeded
inputs: ``run --backend host`` must give the same bytes, an index saved
by either must load in the other, and the host primitives must agree
bit for bit.
"""

import contextlib
import gc
import gzip
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import malva_tpu.cli as mcli
import malva_tpu.pipeline as mp
from malva_tpu.utils.config import Config as MConfig
from malva_tpu_torch import cli as tcli
from malva_tpu_torch import pipeline as tp
from malva_tpu_torch.utils.config import Config as TConfig
from fuzz_gen import gen_case

# setting -> (gen_case seed, haploid, CLI flags, input form)
SETTINGS = {
    "diploid -b 1": (201, False, ["-b", "1"], None),
    "haploid -b 1": (202, True, ["-1", "-b", "1"], None),
    "diploid -b 4": (203, False, ["-b", "4"], None),
    "haploid -b 4": (204, True, ["-1", "-b", "4"], None),
    "bcf input": (205, False, ["-b", "1"], "bcf"),
    "gzip reads": (206, True, ["-1", "-b", "1"], "gz"),
    "spill dir": (207, False, ["-b", "1"], "spill"),
    "kmc dump": (208, False, ["-b", "1"], "kmc"),
    "overlapped producer": (209, False, ["-b", "1"], "overlap"),
}


def _prepare(src: str, work: str, form: str | None) -> tuple[list[str], list[str]]:
    """Private copies of the inputs in ``work`` in the setting's form ->
    (positional args, extra flags)."""
    os.makedirs(work)
    fa, vcf, reads = (shutil.copy(os.path.join(src, n), os.path.join(work, n))
                      for n in ("ref.fa", "vars.vcf", "reads.fa"))
    flags: list[str] = []
    if form == "bcf":
        from malva_tpu.io.bcf import write_bcf
        from malva_tpu.io.vcf import VcfReader

        r = VcfReader(vcf)
        vcf = os.path.join(work, "vars.bcf")
        write_bcf(vcf, r.meta_lines, r.sample_names, list(r), freq_key="AF")
    elif form == "gz":
        with open(reads, "rb") as f, gzip.open(reads + ".gz", "wb") as g:
            g.write(f.read())
        reads += ".gz"
    elif form == "spill":
        flags = ["--spill-dir", os.path.join(work, "spill")]
    elif form == "kmc":
        from malva_tpu.count.counter import count_reads_kmers

        kmers, counts = count_reads_kmers(reads, 43, log=io.StringIO())
        reads = os.path.join(work, "reads.kmc.txt")
        with open(reads, "w") as f:
            f.writelines(f"{k.tobytes().decode()}\t{c}\n" for k, c in zip(kmers, counts))
        flags = ["--from-kmc-dump"]
    return [fa, vcf, reads], flags


def _run_malva_tpu(argv: list[str]) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert mcli.main(argv) == 0
    return out.getvalue()


def _run_port(argv: list[str]) -> str:
    out = io.StringIO()
    assert tcli.main(argv, out=out) == 0
    return out.getvalue()


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_run_host_byte_identical(tmp_path, monkeypatch, setting):
    """``run --backend host`` of the port == malva_tpu's, on private copies
    of the same seeded input (each run builds and saves its own index).
    "overlapped producer" counts in each package's spill producer child."""
    seed, haploid, flags, form = SETTINGS[setting]
    monkeypatch.delenv("MALVA_NO_OVERLAP", raising=False)
    monkeypatch.setenv("MALVA_OVERLAP_MIN_BYTES", "0" if form == "overlap" else str(1 << 40))
    src = tmp_path / "src"
    src.mkdir()
    gen_case(str(src), seed, haploid=haploid)
    outs = {}
    for name, run in (("malva_tpu", _run_malva_tpu), ("port", _run_port)):
        inputs, extra = _prepare(str(src), str(tmp_path / name), form)
        outs[name] = run(["run", "--backend", "host", *flags, *extra, *inputs])
        gc.collect()  # -b 4 holds GiB of Bloom words and ranks
    assert outs["port"].count("\n") > 20
    assert outs["port"] == outs["malva_tpu"]


@pytest.mark.parametrize("direction", ["malva_tpu->port", "port->malva_tpu"])
def test_saved_index_loads_in_the_other_package(tmp_path, direction):
    """An index saved by one package loads in the other, and ``call``
    there gives the VCF of the saving package's own ``call``."""
    fa, vcf, reads = gen_case(str(tmp_path), 211)
    kw = dict(fasta_path=fa, vcf_path=vcf, sample_path=reads, bf_size=1 << 22)
    mcfg, tcfg = MConfig(**kw), TConfig(**kw)
    saver, loader = (mp, tp) if direction == "malva_tpu->port" else (tp, mp)
    scfg, lcfg = (mcfg, tcfg) if saver is mp else (tcfg, mcfg)
    path = str(tmp_path / "index.npz")
    built = saver.build_index(scfg)
    saver.save_index(built, path, scfg)
    want = io.StringIO()
    saver.call(scfg, built, want)
    assert loader.index_matches_config(path, lcfg)[0]
    loaded = loader.load_index(path)
    np.testing.assert_array_equal(loaded.bf.words, built.bf.words)
    np.testing.assert_array_equal(loaded.context_bf.words, built.context_bf.words)
    assert list(loaded.ref_bf.kmers) == list(built.ref_bf.kmers)
    got = io.StringIO()
    loader.call(lcfg, loaded, got)
    assert got.getvalue() == want.getvalue()


def _rows(rng, n: int, k: int, alphabet: bytes) -> np.ndarray:
    a = np.frombuffer(alphabet, dtype=np.uint8)
    return a[rng.integers(0, a.shape[0], size=(n, k))]


@pytest.mark.parametrize("length", [0, 1, 3, 4, 8, 9, 16, 17, 35, 43, 128, 129, 240, 241, 500])
def test_xxh3_64_parity(length):
    from malva_tpu.ops.xxh3 import xxh3_64 as m_xxh3
    from malva_tpu_torch.ops.xxh3 import xxh3_64 as t_xxh3

    rows = _rows(np.random.default_rng(length), 64, length, bytes(range(256)))
    np.testing.assert_array_equal(t_xxh3(rows), m_xxh3(rows))


@pytest.mark.parametrize("k", [1, 15, 35, 43, 64])
def test_canonical_and_packing_parity(k):
    from malva_tpu.ops import seq as mseq
    from malva_tpu_torch.ops import seq as tseq

    rng = np.random.default_rng(k)
    mixed = _rows(rng, 512, k, b"ACGTACGTACGTacgtnNRYSWKM")
    np.testing.assert_array_equal(tseq.canonical(mixed), mseq.canonical(mixed))
    np.testing.assert_array_equal(tseq.RCN_TABLE, mseq.RCN_TABLE)
    acgt = mseq.canonical(_rows(rng, 512, k, b"ACGT"))
    packed = tseq.pack_2bit(acgt)
    np.testing.assert_array_equal(packed, mseq.pack_2bit(acgt))
    np.testing.assert_array_equal(tseq.unpack_2bit(packed, k), acgt)


@pytest.mark.parametrize("n_keys", [0, 1, 1000, 20000])
def test_bucket_table_parity(n_keys):
    from malva_tpu.index.kmap_table import BucketTable as MTable
    from malva_tpu_torch.index.kmap_table import BucketTable as TTable

    rng = np.random.default_rng(n_keys)
    keys = [r.tobytes() for r in _rows(rng, n_keys, 35, b"ACGT")]
    m, t = MTable(keys, 35), TTable(keys, 35)
    assert t.n_buckets == m.n_buckets
    np.testing.assert_array_equal(t.bucket_keys, m.bucket_keys)
    assert t.slot_keys == m.slot_keys


@pytest.mark.parametrize("ref_k", [31, 43, 63])
def test_host_sort_count_parity(tmp_path, ref_k):
    """The host counter (windows, canonical pack, sort-count, merge,
    ci/cs) of both packages, one flush and many."""
    from malva_tpu.count import counter as mcounter
    from malva_tpu_torch.count import counter as tcounter

    _, _, reads = gen_case(str(tmp_path), 300 + ref_k)
    for chunk in (1 << 25, 2000):
        want = mcounter.count_reads_kmers(reads, ref_k, chunk_kmers=chunk, log=io.StringIO(),
                                          return_packed=True)
        got = tcounter.count_reads_kmers(reads, ref_k, chunk_kmers=chunk, log=io.StringIO(),
                                         return_packed=True)
        assert got[0].shape[0] > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(ref_k)
    packed = rng.integers(0, 50, size=(5000, (ref_k + 31) // 32)).astype(np.uint64)
    for g, w in zip(tcounter._sorted_counts(packed), mcounter._sorted_counts(packed)):
        np.testing.assert_array_equal(g, w)


def test_native_loader_builds_into_build_native():
    """The port's loader compiles native/host_kernels.cpp into build/native/
    and loads it; ``native/libmalva_host.so`` stays malva_tpu's."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no g++ to build the native host library")
    from malva_tpu_torch.utils import native

    lib = native.load()
    assert lib is not None
    assert os.path.dirname(lib._name) == str(native.BUILD_DIR)
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")


def test_native_loader_builds_without_openmp(tmp_path, monkeypatch):
    """Where the compiler refuses -fopenmp, the loader builds again without
    it and logs one line saying so."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no g++ to build the native host library")
    from malva_tpu_torch.utils import native

    fake = tmp_path / "cxx-without-openmp"
    fake.write_text(f'#!/bin/sh\nfor a in "$@"; do [ "$a" = -fopenmp ] && exit 1; done\n'
                    f'exec {cxx} "$@"\n')
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build" / "native")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        so = native._build()
    assert so.parent == tmp_path / "build" / "native" and so.exists()
    assert err.getvalue().count("\n") == 1 and "without OpenMP" in err.getvalue()


def test_native_loader_falls_back_with_one_line(monkeypatch):
    """Without a library the host layers take their Python path and the
    loader says so once."""
    from malva_tpu_torch.utils import native

    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "SOURCE", native.SOURCE.with_name("missing.cpp"))
    monkeypatch.delenv("MALVA_NO_NATIVE", raising=False)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert native.load() is None
        assert native.load() is None
    assert err.getvalue().count("\n") == 1 and "using Python path" in err.getvalue()


PRODUCER = r"""
import sys
from malva_tpu_torch.count import spill
assert spill._produce_main(sys.argv[1:]) == 0
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "malva_tpu")))
"""


def test_spill_producer_is_the_ports(tmp_path):
    """The overlapped ``run``'s producer child (the port's spill module)
    counts and spills without loading jax or malva_tpu."""
    _, _, reads = gen_case(str(tmp_path), 212)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    res = subprocess.run([sys.executable, "-c", PRODUCER, reads, "43", str(tmp_path / "spill")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"
    assert (tmp_path / "spill" / "manifest.json").exists()
