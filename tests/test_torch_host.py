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
    """The port's loader compiles its own csrc/host_kernels.cpp, inside
    the package (not the repository's native/ source), into build/native/
    of the checkout and loads it; ``native/libmalva_host.so`` stays
    malva_tpu's."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no g++ to build the native host library")
    from pathlib import Path

    import malva_tpu_torch
    from malva_tpu_torch.utils import native

    pkg = Path(malva_tpu_torch.__file__).resolve().parent
    assert native.SOURCE == pkg / "csrc" / "host_kernels.cpp" and native.SOURCE.is_file()
    assert "native" not in native.SOURCE.relative_to(pkg.parent).parts[:1]
    lib = native.load()
    assert lib is not None
    assert os.path.dirname(lib._name) == str(native.BUILD_DIR)
    assert native.BUILD_DIR == pkg.parent / "build" / "native"


OUTSIDE = r"""
import os, sys
from malva_tpu_torch.ops import _build
from malva_tpu_torch.utils import native
lib = native.load()
assert lib is not None, "no library"
print(lib._name)
print(_build.BUILD_DIR)
print(native.build_form(), native.threads())
"""


def test_native_loader_builds_outside_the_checkout(tmp_path):
    """A copy of the package in a read-only directory outside any checkout
    (an installed package) builds its host library from its own source into
    the user's cache directory and loads it; the CUDA kernels would build
    there too."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no g++ to build the native host library")
    import malva_tpu_torch

    site = tmp_path / "site"
    shutil.copytree(os.path.dirname(malva_tpu_torch.__file__), site / "malva_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    dirs = [site, *(p for p in site.rglob("*") if p.is_dir())]
    for d in dirs:
        d.chmod(0o555)
    env = {k: v for k, v in os.environ.items() if k not in ("MALVA_NO_NATIVE", "PYTHONPATH")}
    env.update(HOME=str(tmp_path / "home"), XDG_CACHE_HOME=str(tmp_path / "cache"),
               PYTHONPATH=str(site), PYTHONDONTWRITEBYTECODE="1")
    try:
        res = subprocess.run([sys.executable, "-c", OUTSIDE], cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=600)
    finally:
        for d in dirs:
            d.chmod(0o755)
    assert res.returncode == 0, res.stderr[-2000:]
    so, kernels_dir, facts = res.stdout.splitlines()
    cache = tmp_path / "cache" / "malva_tpu_torch"
    assert os.path.dirname(so) == str(cache / "native") and os.path.exists(so)
    assert kernels_dir == str(cache / "kernels")
    assert facts.split()[0] in ("a", "b", "none")
    assert res.stderr.count("native host library built") == 1


def _port_run(tmp_path, name: str, inputs: list[str], threads: int, flags=(),
              library: bool = True) -> bytes:
    """``run --backend host`` of the port in a fresh process with
    OMP_NUM_THREADS set, and without the native library where not
    ``library`` -> the VCF bytes."""
    env = dict(os.environ, OMP_NUM_THREADS=str(threads),
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env.pop("MALVA_NO_NATIVE", None)
    if not library:
        env["MALVA_NO_NATIVE"] = "1"
    work = tmp_path / f"{name}-{threads}"
    work.mkdir()
    args = [shutil.copy(p, work / os.path.basename(p)) for p in inputs]
    res = subprocess.run([sys.executable, "-m", "malva_tpu_torch.cli", "run", "--backend", "host",
                          "-b", "1", *flags, *map(str, args)], env=env, capture_output=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout


@pytest.mark.parametrize("case", ["diploid", "fuzz"])
def test_host_run_does_not_depend_on_threads(tmp_path, case):
    """``run --backend host`` gives the same VCF bytes with the native
    library's loops on one thread and on four: the diploid fixture's
    golden VCF, and a seeded fuzz input's."""
    if case == "diploid":
        d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "diploid")
        inputs = [os.path.join(d, n) for n in ("ref.fa", "vars.vcf", "reads.fa")]
    else:
        (tmp_path / "src").mkdir()
        inputs = list(gen_case(str(tmp_path / "src"), 213))
    one, four = (_port_run(tmp_path, case, inputs, n) for n in (1, 4))
    assert one.count(b"\n") > 20
    assert one == four
    if case == "diploid":
        assert one == open(os.path.join(d, "golden.vcf"), "rb").read()


@pytest.mark.parametrize("case", ["diploid", "haploid fuzz"])
def test_host_run_without_the_library(tmp_path, case):
    """``run --backend host`` without the native library (Python's GT
    decode, extraction and combinations) gives the VCF bytes it gives with
    it: the diploid fixture's golden VCF, and a seeded haploid fuzz
    input's."""
    if case == "diploid":
        d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "diploid")
        inputs = [os.path.join(d, n) for n in ("ref.fa", "vars.vcf", "reads.fa")]
        flags = []
        with open(os.path.join(d, "golden.vcf"), "rb") as f:
            want = f.read()
    else:
        (tmp_path / "src").mkdir()
        inputs = list(gen_case(str(tmp_path / "src"), 214, haploid=True))
        flags = ["-1"]
        want = _port_run(tmp_path, "library", inputs, 2, flags)
    got = _port_run(tmp_path, "python", inputs, 2, flags, library=False)
    assert got.count(b"\n") > 20
    assert got == want


def test_malva_threads_reports_the_count_given():
    """malva_threads() is the loops' team size: OMP_NUM_THREADS where set."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no g++ to build the native host library")
    from malva_tpu_torch.utils import native

    assert native.load() is not None
    if native.build_form() == "none":
        pytest.skip("this g++ builds the library without OpenMP")
    env = dict(os.environ, OMP_NUM_THREADS="3",
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    res = subprocess.run([sys.executable, "-c", "from malva_tpu_torch.utils import native; "
                          "print(native.threads())"], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "3"


def test_native_loader_links_torch_libgomp(tmp_path, monkeypatch):
    """Where g++ compiles -fopenmp but cannot link its runtime, the loader
    links the libgomp.so.1 that torch carries (form b), and the library's
    loops run on the threads asked for."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no g++ to build the native host library")
    from malva_tpu_torch.utils import native

    if native.torch_gomp() is None:
        pytest.skip("this torch package carries no libgomp")
    fake = tmp_path / "cxx-without-openmp-runtime"
    fake.write_text('#!/bin/sh\ncase " $* " in *" -c "*) ;; *" -fopenmp "*) exit 1 ;; esac\n'
                    f'exec {cxx} "$@"\n')
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build" / "native")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        so = native._build()
    assert err.getvalue().count("\n") == 1 and "form b" in err.getvalue()
    assert native._threads_of(so, "2") == 2


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
