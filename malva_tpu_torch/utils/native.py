"""ctypes bindings for the native host kernels (csrc/host_kernels.cpp).

The port's copy of ``malva_tpu/utils/native.py``, with its own source
and its own build: at first use g++ compiles the package's
``csrc/host_kernels.cpp`` with the Makefile's flags into
``utils/build_dir.py``'s ``native`` directory (``build/native/`` in a
checkout, else the user's cache directory).  The file name carries a
digest of the source, the flags and the CPU model, so an edited source,
or another CPU for ``-march=native``, builds anew.

The OpenMP loops need an OpenMP runtime.  The build takes the first of
these forms that builds and runs on more than one thread:

* ``a``: ``-fopenmp``, g++'s own runtime;
* ``b``: ``-fopenmp`` to compile, linked against the ``libgomp.so.1``
  that the installed torch package carries (``torch/lib`` or
  ``torch.libs``), by its full path with an rpath, for a g++ that has
  ``omp.h`` but no runtime to link: the process then holds one OpenMP
  runtime, torch's;
* ``none``: without ``-fopenmp``; the loops run on one thread.

Each form compiles with ``-DMALVA_ZLIB`` and links ``-lz`` where the
compiler finds ``zlib.h`` and the library (a probe at build time): the
VCF record scanner (``VcfScan``) then inflates gzip itself; without
zlib it takes plain-text VCFs only, and pass 2 reads gzip on the Python
path.

The results do not depend on the thread count.  One stderr line says
which form was built, on how many threads its loops run
(``malva_threads()``) and whether with zlib.  If no library builds or loads, every caller falls
back to the pure Python implementation (results are identical either way,
parity-tested) and one stderr line says so: it is several times slower
at chromosome scale.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import importlib.machinery
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from .build_dir import build_dir

_LIB = None
_TRIED = False

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host_kernels.cpp"
BUILD_DIR = build_dir("native")
CXXFLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-std=c++17", "-fPIC", "-Wall")
_THREADS = "import ctypes, sys; print(ctypes.CDLL(sys.argv[1]).malva_threads())"


def _cpu_model() -> bytes:
    """The CPU's model line: -march=native builds for this CPU only."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"model name")), b"")
    except OSError:
        return b""


def torch_gomp() -> "Path | None":
    """The OpenMP runtime the installed torch package carries, found
    without importing torch, or None.  Looked up on ``sys.path`` past the
    import finders, so a process that refuses torch's import (the spill
    producer) still builds the library in the form the card's machine
    needs."""
    spec = importlib.machinery.PathFinder.find_spec("torch")
    if spec is None or not spec.submodule_search_locations:
        return None
    pkg = Path(next(iter(spec.submodule_search_locations)))
    found = sorted((pkg / "lib").glob("libgomp*.so*")) + sorted(
        (pkg.parent / "torch.libs").glob("libgomp*.so*"))
    return found[0] if found else None


def _threads_of(so: Path, omp_threads: "str | None") -> int:
    """malva_threads() of the library at ``so``, loaded in a fresh Python
    process with OMP_NUM_THREADS set to ``omp_threads`` (None: as here);
    0 when it does not load."""
    env = dict(os.environ)
    if omp_threads is not None:
        env["OMP_NUM_THREADS"] = omp_threads
    r = subprocess.run([sys.executable, "-c", _THREADS, str(so)], env=env, capture_output=True,
                       text=True, timeout=60)
    return int(r.stdout) if r.returncode == 0 and r.stdout.strip().isdigit() else 0


_ZLIB_PROBE = "#include <zlib.h>\nint main() { return zlibVersion()[0] == 0; }\n"


def _has_zlib(cxx: str, out: Path) -> bool:
    """Whether ``cxx`` compiles against ``zlib.h`` and links ``-lz``: the
    record scanner then inflates gzip itself (``malva_has_zlib``)."""
    probe = out.with_suffix(".zlib")
    try:
        r = subprocess.run([cxx, "-x", "c++", "-", "-lz", "-o", str(probe)], input=_ZLIB_PROBE,
                           capture_output=True, text=True, timeout=120)
        return r.returncode == 0
    finally:
        probe.unlink(missing_ok=True)


def _forms(cxx: str, out: Path, zlib: bool = False) -> list:
    """(form, note, commands) of each build form, in the order tried; with
    ``zlib``, each compiles with ``-DMALVA_ZLIB`` and links ``-lz``."""
    def define(form: str) -> list:
        return [f'-DMALVA_BUILD_FORM="{form}"', *(["-DMALVA_ZLIB"] if zlib else [])]

    lz = ["-lz"] if zlib else []
    forms = [("a", "with OpenMP (-fopenmp)",
              [[cxx, *CXXFLAGS, "-fopenmp", *define("a"), "-shared", "-o", str(out),
                str(SOURCE), *lz]])]
    gomp = torch_gomp()
    if gomp is not None:
        obj = out.with_suffix(".o")
        forms.append(("b", f"with OpenMP (-fopenmp, linked against torch's {gomp})",
                      [[cxx, *CXXFLAGS, "-fopenmp", *define("b"), "-c", "-o", str(obj),
                        str(SOURCE)],
                       [cxx, "-shared", "-o", str(out), str(obj), str(gomp),
                        f"-Wl,-rpath,{gomp.parent}", *lz]]))
    forms.append(("none", "without OpenMP (no OpenMP runtime for g++ here; its loops run on "
                          "one thread)",
                  [[cxx, *CXXFLAGS, *define("none"), "-shared", "-o", str(out), str(SOURCE),
                    *lz]]))
    return forms


def _build() -> Path:
    """The library for this source, these flags and this CPU, compiled if
    missing in the first form (a, b, none) that builds and, but for none,
    runs its loops on two threads when asked to.  Raises when no form
    builds."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()
                            + _cpu_model()).hexdigest()[:16]
    so = BUILD_DIR / f"libmalva_host_{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one build for processes that start together
        if so.exists():
            return so
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        err = ""
        cxx = os.environ.get("CXX", "g++")
        zlib = _has_zlib(cxx, tmp)
        try:
            for form, note, cmds in _forms(cxx, tmp, zlib):
                for cmd in cmds:
                    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
                    if r.returncode != 0:
                        err = r.stderr.strip()[-300:]
                        break
                else:
                    if form == "none" or _threads_of(tmp, "2") == 2:
                        threads = _threads_of(tmp, None)
                        os.replace(tmp, so)
                        print(f"[malva-tpu-torch] native host library built {note}, form "
                              f"{form}, {threads} thread{'s' * (threads != 1)}, "
                              f"{'with' if zlib else 'without'} zlib: {so}", file=sys.stderr)
                        return so
                    err = f"form {form} built but does not run on two threads"
        finally:
            tmp.unlink(missing_ok=True)
            tmp.with_suffix(".o").unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed: {err}")


def threads() -> "int | None":
    """The thread count of the library's loops (its malva_threads()), or
    None without the library."""
    lib = load()
    return None if lib is None else int(lib.malva_threads())


def build_form() -> "str | None":
    """Which build form the loaded library is (a, b or none), or None
    without the library."""
    lib = load()
    return None if lib is None else lib.malva_build_form().decode()


def load() -> "ctypes.CDLL | None":
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("MALVA_NO_NATIVE"):
        return None
    try:
        if not SOURCE.exists():
            raise FileNotFoundError(SOURCE)
        so = str(_build())
        lib = ctypes.CDLL(so)
        lib.malva_threads.restype = ctypes.c_int
        lib.malva_threads.argtypes = []
        lib.malva_build_form.restype = ctypes.c_char_p
        lib.malva_build_form.argtypes = []
        lib.malva_bf_rank.restype = ctypes.c_uint64
        lib.malva_bf_rank.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.malva_popcount_sum.restype = ctypes.c_uint64
        lib.malva_popcount_sum.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ]
        lib.malva_parse_gt.restype = ctypes.c_int64
        lib.malva_parse_gt.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        lib.malva_genotype_block.restype = ctypes.c_int64
        lib.malva_genotype_block.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int, ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        for name, args in [
            ("malva_xxh3_batch", [u8p, ctypes.c_int64, ctypes.c_int64, u64p]),
            ("malva_canonical", [u8p, ctypes.c_int64, ctypes.c_int64, u8p]),
            ("malva_canonical_xxh3", [u8p, ctypes.c_int64, ctypes.c_int64, u64p]),
            ("malva_pack2bit", [u8p, ctypes.c_int64, ctypes.c_int64, u64p]),
            ("malva_truncate_nul", [u8p, ctypes.c_int64, ctypes.c_int64, u8p]),
            ("malva_coverage", [
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
            ]),
            ("malva_count_windows", [
                u8p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ]),
            ("malva_read_kmers", [
                u8p, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_int64, u64p,
            ]),
        ]:
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = args
        for name, args in [
            ("malva_unpack2bit", [u64p, ctypes.c_int64, ctypes.c_int64, u8p]),
            ("malva_apply_ctx_packed", [
                u64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                u64p, u64p, u64p,
            ]),
            ("malva_argsort_u64rows", [
                u64p, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
            ]),
            ("malva_search_u64rows", [
                u64p, ctypes.c_int64, u64p, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
            ]),
        ]:
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = args
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        for name in ("malva_scatter_add_u32", "malva_scatter_or_u32"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [u32p, i64p, u32p, ctypes.c_int64]
        lib.malva_bf_apply_hashed.restype = None
        lib.malva_bf_apply_hashed.argtypes = [
            u64p, u64p, u32p, ctypes.c_int64,
            ctypes.c_uint64, u32p, ctypes.c_uint64, u32p, u32p, u32p,
        ]
        lib.malva_parse_gt_spans.restype = None
        lib.malva_parse_gt_spans.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.malva_has_zlib.restype = ctypes.c_int
        lib.malva_has_zlib.argtypes = []
        lib.malva_vcf_open.restype = ctypes.c_void_p
        lib.malva_vcf_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64]
        lib.malva_vcf_scan.restype = None
        lib.malva_vcf_scan.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.POINTER(_ScanView)]
        lib.malva_vcf_put.restype = None
        lib.malva_vcf_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64]
        lib.malva_vcf_close.restype = None
        lib.malva_vcf_close.argtypes = [ctypes.c_void_p]
        lib.malva_extract_group.restype = ctypes.c_void_p
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p_ = ctypes.POINTER(ctypes.c_int64)
        lib.malva_extract_group.argtypes = [
            ctypes.c_int64, i64p_, u64p, i64p_,           # blocks, refs
            i64p_, i64p_, i64p_, u8p,                     # pos/size/min/present
            i64p_, i64p_, u8p,                            # alleles
            u64p, u64p, u64p, ctypes.c_int64,             # gt ptrs, n_ind
            ctypes.c_int64, ctypes.c_int,                 # k, haploid
            i64p_,                                        # out_counts
        ]
        lib.malva_extract_take.restype = None
        lib.malva_extract_take.argtypes = [
            ctypes.c_void_p, i32p, i32p, i32p,            # handle, targets
            i32p, i32p, u8p,                              # sig_nk, kmer_len, bytes
        ]
        lib.malva_extract_free.restype = None
        lib.malva_extract_free.argtypes = [ctypes.c_void_p]
        lib.malva_sort_count.restype = ctypes.c_int64
        lib.malva_sort_count.argtypes = [u64p, ctypes.c_int64, i64p]
        lib.malva_merge_runs.restype = ctypes.c_int64
        lib.malva_merge_runs.argtypes = [
            u64p, i64p, ctypes.c_int64, u64p, i64p, ctypes.c_int64, u64p, i64p,
        ]
        _LIB = lib
    except Exception as e:  # pragma: no cover - environment dependent
        print(f"[malva-tpu-torch] native kernels unavailable ({e}); using Python path",
              file=sys.stderr)
        _LIB = None
    return _LIB


_U8P = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)


def _rows(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


def xxh3_batch(a: np.ndarray) -> "np.ndarray | None":
    """XXH3_64bits per row of (N, L) uint8; None -> caller uses numpy."""
    lib = load()
    if lib is None:
        return None
    a = _rows(a)
    n, length = a.shape
    out = np.empty(n, dtype=np.uint64)
    lib.malva_xxh3_batch(a.ctypes.data_as(_U8P), n, length,
                         out.ctypes.data_as(_U64P))
    return out


def canonical(a: np.ndarray) -> "np.ndarray | None":
    lib = load()
    if lib is None:
        return None
    a = _rows(a)
    n, k = a.shape
    out = np.empty_like(a)
    lib.malva_canonical(a.ctypes.data_as(_U8P), n, k, out.ctypes.data_as(_U8P))
    return out


def canonical_xxh3(a: np.ndarray) -> "np.ndarray | None":
    """Fused canonical + XXH3 (no canonical matrix materialized)."""
    lib = load()
    if lib is None:
        return None
    a = _rows(a)
    n, k = a.shape
    out = np.empty(n, dtype=np.uint64)
    lib.malva_canonical_xxh3(a.ctypes.data_as(_U8P), n, k,
                             out.ctypes.data_as(_U64P))
    return out


def pack2bit(a: np.ndarray) -> "np.ndarray | None":
    lib = load()
    if lib is None:
        return None
    a = _rows(a)
    n, k = a.shape
    out = np.empty((n, (k + 31) // 32), dtype=np.uint64)
    lib.malva_pack2bit(a.ctypes.data_as(_U8P), n, k, out.ctypes.data_as(_U64P))
    return out


def truncate_nul(a: np.ndarray) -> "np.ndarray | None":
    lib = load()
    if lib is None:
        return None
    a = _rows(a)
    n, k = a.shape
    out = np.empty_like(a)
    lib.malva_truncate_nul(a.ctypes.data_as(_U8P), n, k, out.ctypes.data_as(_U8P))
    return out


_I64P = ctypes.POINTER(ctypes.c_int64)


def read_kmers(seqs: "list[bytes]", k: int) -> "np.ndarray | None":
    """Packed canonical k-mers ((N, ceil(k/32)) u64, pack_2bit layout) of
    every pure-ACGT k-window of the given reads, in read order; None when
    the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(seqs)
    data = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter((len(s) for s in seqs), np.int64, n), out=offs[1:])
    counts = np.empty(n, dtype=np.int64)
    lib.malva_count_windows(data.ctypes.data_as(_U8P),
                            offs.ctypes.data_as(_I64P), n, k,
                            counts.ctypes.data_as(_I64P))
    out_offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=out_offs[1:])
    out = np.empty((int(out_offs[-1]), (k + 31) // 32), dtype=np.uint64)
    lib.malva_read_kmers(data.ctypes.data_as(_U8P),
                         offs.ctypes.data_as(_I64P),
                         out_offs.ctypes.data_as(_I64P), n, k,
                         out.ctypes.data_as(_U64P))
    return out


def unpack2bit(packed: np.ndarray, k: int) -> "np.ndarray | None":
    """Inverse of pack2bit back to (N, K) ASCII; None -> numpy path."""
    lib = load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.uint64)
    n = packed.shape[0]
    out = np.empty((n, k), dtype=np.uint8)
    lib.malva_unpack2bit(packed.ctypes.data_as(_U64P), n, k,
                         out.ctypes.data_as(_U8P))
    return out


def apply_ctx_packed(packed: np.ndarray, ref_k: int, k: int):
    """Fused host apply-path front end over packed canonical contexts:
    (ctx_hash, center_hash, center_packed) per row, or None."""
    lib = load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.uint64)
    n = packed.shape[0]
    ctx_h = np.empty(n, dtype=np.uint64)
    cen_h = np.empty(n, dtype=np.uint64)
    cen_pk = np.empty((n, (k + 31) // 32), dtype=np.uint64)
    lib.malva_apply_ctx_packed(
        packed.ctypes.data_as(_U64P), n, ref_k, k,
        ctx_h.ctypes.data_as(_U64P), cen_h.ctypes.data_as(_U64P),
        cen_pk.ctypes.data_as(_U64P),
    )
    return ctx_h, cen_h, cen_pk


def argsort_u64rows(a: np.ndarray) -> "np.ndarray | None":
    """Argsort of (N, W) uint64 rows in lexicographic row order (== ASCII
    k-mer order under pack_2bit's layout); None when unavailable."""
    lib = load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.uint64)
    n, w = a.shape
    perm = np.empty(n, dtype=np.int64)
    lib.malva_argsort_u64rows(a.ctypes.data_as(_U64P), n, w,
                              perm.ctypes.data_as(_I64P))
    return perm


def search_u64rows(sorted_rows: np.ndarray, probes: np.ndarray) -> "np.ndarray | None":
    """Exact-match position of each probe row in sorted_rows (-1 when
    absent); None when unavailable."""
    lib = load()
    if lib is None:
        return None
    sorted_rows = np.ascontiguousarray(sorted_rows, dtype=np.uint64)
    probes = np.ascontiguousarray(probes, dtype=np.uint64)
    m, w = sorted_rows.shape
    n = probes.shape[0]
    pos = np.empty(n, dtype=np.int64)
    lib.malva_search_u64rows(sorted_rows.ctypes.data_as(_U64P), m,
                             probes.ctypes.data_as(_U64P), n, w,
                             pos.ctypes.data_as(_I64P))
    return pos


def sort_count(keys: np.ndarray) -> "tuple[np.ndarray, np.ndarray] | None":
    """Lexicographic row sort + run-length count of (N, W<=2) u64 rows
    (parallel); returns (unique_keys, counts) or None.  The input array is
    never modified (a working copy is sorted in place)."""
    lib = load()
    if lib is None or keys.shape[1] > 2:
        return None
    n, W = keys.shape
    if W == 1:
        k2 = np.zeros((n, 2), dtype=np.uint64)
        k2[:, 0] = keys[:, 0]
    else:
        k2 = np.array(keys, dtype=np.uint64)  # always a fresh copy
    cnts = np.empty(max(n, 1), dtype=np.int64)
    u = lib.malva_sort_count(k2.ctypes.data_as(_U64P), n,
                             cnts.ctypes.data_as(_I64P))
    # .copy(): returning views would pin the full n-row buffers
    return k2[:u, :W].copy(), cnts[:u].copy()


def bucket_partition(keys: np.ndarray, cnts: np.ndarray, n_buckets: int):
    """Stable spill-bucket partition of (n, w<=2) u64 rows + counts:
    (keys_bucket_major, cnts, offs[n_buckets+1]) or None.  Bit-identical
    to count.spill._bucket_of (see malva_bucket_partition)."""
    lib = load()
    if (lib is None or keys.ndim != 2 or keys.shape[1] > 2
            or keys.dtype != np.uint64 or n_buckets < 2):
        return None  # n_buckets==1 would need shift 64 (UB in C/C++)
    n, w = keys.shape
    shift = 64 - (int(n_buckets).bit_length() - 1)
    keys = np.ascontiguousarray(keys)
    cnts = np.ascontiguousarray(cnts, dtype=np.uint32)
    out_k = np.empty_like(keys)
    out_c = np.empty(n, dtype=np.uint32)
    offs = np.empty(n_buckets + 1, dtype=np.int64)
    lib.malva_bucket_partition(
        keys.ctypes.data_as(_U64P), cnts.ctypes.data_as(_U32P), n, w, shift,
        n_buckets, out_k.ctypes.data_as(_U64P), out_c.ctypes.data_as(_U32P),
        offs.ctypes.data_as(_I64P),
    )
    return out_k, out_c, offs


def merge_runs(keys_a, cnt_a, keys_b, cnt_b) -> "tuple[np.ndarray, np.ndarray] | None":
    """Linear merge of two sorted distinct (key, count) runs, summing
    counts; None when unavailable or rows wider than 2 words."""
    lib = load()
    if lib is None or keys_a.shape[1] > 2:
        return None
    na, W = keys_a.shape
    nb = keys_b.shape[0]
    if W == 1:
        ka = np.zeros((na, 2), dtype=np.uint64)
        ka[:, 0] = keys_a[:, 0]
        kb = np.zeros((nb, 2), dtype=np.uint64)
        kb[:, 0] = keys_b[:, 0]
    else:
        ka = np.ascontiguousarray(keys_a, dtype=np.uint64)
        kb = np.ascontiguousarray(keys_b, dtype=np.uint64)
    ca = np.ascontiguousarray(cnt_a, dtype=np.int64)
    cb = np.ascontiguousarray(cnt_b, dtype=np.int64)
    ko = np.empty((na + nb, 2), dtype=np.uint64)
    co = np.empty(na + nb, dtype=np.int64)
    m = lib.malva_merge_runs(
        ka.ctypes.data_as(_U64P), ca.ctypes.data_as(_I64P), na,
        kb.ctypes.data_as(_U64P), cb.ctypes.data_as(_I64P), nb,
        ko.ctypes.data_as(_U64P), co.ctypes.data_as(_I64P),
    )
    # .copy(): returning views would pin the full (na+nb)-row buffers
    return ko[:m, :W].copy(), co[:m].copy()


_U32P = ctypes.POINTER(ctypes.c_uint32)


def scatter_add_u32(buf: np.ndarray, idx: np.ndarray, vals: np.ndarray) -> bool:
    """buf[idx] += vals with repeats (np.add.at semantics, ~20x faster).
    Returns False when the native library is unavailable."""
    lib = load()
    if lib is None:
        return False
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    lib.malva_scatter_add_u32(buf.ctypes.data_as(_U32P),
                              idx.ctypes.data_as(_I64P),
                              vals.ctypes.data_as(_U32P), idx.shape[0])
    return True


def bf_apply_hashed(ctx_bf, bf, ctx_h: np.ndarray, cen_h: np.ndarray,
                    counters: np.ndarray) -> bool:
    """Fused context-filter test + alt-BF counter increment over
    precomputed XXH3 values (the Bloom half of the packed apply path,
    reference main.cpp:496-499).  Returns False when the native library
    is unavailable or the filter state doesn't fit the kernel's layout
    (caller runs the numpy two-gather path)."""
    lib = load()
    if lib is None or not bf.mode or bf.counts is None:
        return False
    if not ctx_bf.size or not bf.size:
        return False  # modulo-by-zero guard (degenerate filters)
    rank = bf.rank
    if rank is None or rank.dtype != np.uint32:
        return False
    n = int(ctx_h.shape[0])
    if n == 0:
        return True
    cnts = np.ascontiguousarray(counters, dtype=np.uint32)
    ctx_h = np.ascontiguousarray(ctx_h, dtype=np.uint64)
    cen_h = np.ascontiguousarray(cen_h, dtype=np.uint64)
    lib.malva_bf_apply_hashed(
        ctx_h.ctypes.data_as(_U64P), cen_h.ctypes.data_as(_U64P),
        cnts.ctypes.data_as(_U32P), n,
        ctypes.c_uint64(ctx_bf.size), ctx_bf.words.ctypes.data_as(_U32P),
        ctypes.c_uint64(bf.size), bf.words.ctypes.data_as(_U32P),
        rank.ctypes.data_as(_U32P), bf.counts.ctypes.data_as(_U32P),
    )
    return True


def scatter_or_u32(buf: np.ndarray, idx: np.ndarray, vals: np.ndarray) -> bool:
    """buf[idx] |= vals with repeats (np.bitwise_or.at semantics)."""
    lib = load()
    if lib is None:
        return False
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    lib.malva_scatter_or_u32(buf.ctypes.data_as(_U32P),
                             idx.ctypes.data_as(_I64P),
                             vals.ctypes.data_as(_U32P), idx.shape[0])
    return True


def coverage(w: np.ndarray, sig_len: np.ndarray,
             allele_nsig: np.ndarray) -> "np.ndarray | None":
    """Per-allele coverage scan (pipeline._set_coverages_group); None when
    the native library is unavailable (caller runs the Python scan)."""
    lib = load()
    if lib is None:
        return None
    w = np.ascontiguousarray(w, dtype=np.int64)
    sig_len = np.ascontiguousarray(sig_len, dtype=np.int64)
    allele_nsig = np.ascontiguousarray(allele_nsig, dtype=np.int64)
    out = np.empty(allele_nsig.shape[0], dtype=np.int64)
    lib.malva_coverage(
        w.ctypes.data_as(_I64P), sig_len.ctypes.data_as(_I64P),
        sig_len.shape[0], allele_nsig.ctypes.data_as(_I64P),
        allele_nsig.shape[0], out.ctypes.data_as(_I64P),
    )
    return out


def popcount_sum(words: np.ndarray) -> "int | None":
    """Total set bits of a uint32 word array (read-only — no rank array);
    None when the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    return int(lib.malva_popcount_sum(words.ctypes.data_as(u32p), words.shape[0]))


def bf_rank(words: np.ndarray) -> "tuple[np.ndarray, int] | None":
    """Exclusive popcount scan (rank) via the native kernel; None when the
    library is unavailable (caller uses the numpy path)."""
    lib = load()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    rank = np.empty_like(words)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    total = lib.malva_bf_rank(
        words.ctypes.data_as(u32p), words.shape[0], rank.ctypes.data_as(u32p)
    )
    return rank, int(total)


def parse_gt(samples_raw: bytes, n_samples: int, gt_at: int,
             cap: int = 8) -> "tuple[np.ndarray, int] | None":
    """Native GT parse of a record's sample region; None when the library
    is unavailable or the input needs the Python path (malformed /
    ploidy > cap)."""
    lib = load()
    if lib is None or n_samples == 0:
        return None
    buf = np.frombuffer(samples_raw, dtype=np.uint8)
    for c in (cap, 64):  # -1 can mean ploidy overflow: one big retry
        out = np.empty((n_samples, c), dtype=np.int32)
        mp = lib.malva_parse_gt(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.shape[0],
            n_samples, gt_at,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), c,
        )
        if mp > 0:
            return np.ascontiguousarray(out[:, :mp]), int(mp)
        if mp == 0:
            return None
    return None


def genotype_block_native(variants, max_cov: int, haploid: bool, error_rate,
                          labels_fn) -> bool:
    """Native genotype likelihoods over a variant batch; returns False when
    the library is unavailable (caller runs the Python mirror)."""
    lib = load()
    if lib is None or not variants:
        return lib is not None
    n_var = len(variants)
    off = np.zeros(n_var + 1, dtype=np.int64)
    for i, v in enumerate(variants):
        off[i + 1] = off[i] + len(v.coverages)
    cov = np.empty(off[-1], dtype=np.int64)
    freqs = np.empty(off[-1], dtype=np.float32)
    for i, v in enumerate(variants):
        cov[off[i] : off[i + 1]] = v.coverages
        freqs[off[i] : off[i + 1]] = v.frequencies
    # capacity: diploid worst case n*(n+1)/2 per variant
    sizes = np.diff(off)
    cap = int((sizes * (sizes + 1) // 2).sum()) + n_var
    mode = np.zeros(n_var, dtype=np.int8)
    n_out = np.zeros(n_var, dtype=np.int32)
    probs = np.empty(cap, dtype=np.float64)

    w = lib.malva_genotype_block(
        cov.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_var, 1 if haploid else 0, max_cov, ctypes.c_float(float(error_rate)),
        mode.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        n_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        probs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cap,
    )
    if w < 0:  # pragma: no cover - capacity is exact by construction
        return False
    best = "0" if haploid else "0/0"
    at = 0
    for i, v in enumerate(variants):
        m = int(mode[i])
        if m == 1:
            v.computed_gts = [(best, 0.0)] * int(n_out[i])
        elif m == 2:
            v.computed_gts = [(best, 1.0)]
        elif m == 3:
            v.computed_gts = [(best, 0.0)]
        else:
            c = int(n_out[i])
            lab = labels_fn(len(v.coverages), haploid)
            v.computed_gts = list(zip(lab, probs[at : at + c].tolist()))
            at += c
    return True


_I32P = ctypes.POINTER(ctypes.c_int32)


def extract_arrays(blk_off, refs, pos, size, mins, present, al_start, al_off, al_bytes,
                   gt_ptrs, n_ind: int, k: int, haploid: bool):
    """malva_extract_group over a batch given as arrays: ``blk_off`` the
    blocks' variant offsets, ``refs`` each block's reference (a uint8
    array, or None), the variants' positions, REF sizes, shortest allele
    sizes and present flags, their alleles (``al_start`` into ``al_off``
    into ``al_bytes``), and the addresses of each present variant's
    ``n_ind`` GT values (a1 and a2 int32, phase bool; 0 where absent).
    -> (the first variant with an allele index past its ALTs, or -1,
    (tgt_var, tgt_allele, tgt_nsig, sig_nk, kmer_len, bytes_u8), stats),
    or None without the library.  The library keeps its outputs until
    they are copied into arrays of the sizes it reports, so every block
    is extracted once.  ``stats``: the ``blocks`` extracted and the
    ``units`` of work they ran as (a block of more than 64 variants is a
    unit for each 64); ``busy_us``, the units' microseconds on the
    threads that ran them, and ``critical_us``, the longest block's wall,
    first unit to last."""
    lib = load()
    if lib is None:
        return None
    n_blocks = len(refs)
    ref_ptrs = np.zeros(n_blocks, dtype=np.uint64)
    ref_lens = np.zeros(n_blocks, dtype=np.int64)
    for b, rv in enumerate(refs):
        if rv is not None and rv.size:
            ref_ptrs[b] = rv.ctypes.data
            ref_lens[b] = rv.size
    if al_bytes.size == 0:
        al_bytes = np.zeros(1, dtype=np.uint8)
    gt1, gt2, ph = gt_ptrs
    counts = np.zeros(9, dtype=np.int64)
    handle = lib.malva_extract_group(
        n_blocks, blk_off.ctypes.data_as(_I64P),
        ref_ptrs.ctypes.data_as(_U64P), ref_lens.ctypes.data_as(_I64P),
        pos.ctypes.data_as(_I64P), size.ctypes.data_as(_I64P),
        mins.ctypes.data_as(_I64P), present.ctypes.data_as(_U8P),
        al_start.ctypes.data_as(_I64P), al_off.ctypes.data_as(_I64P),
        al_bytes.ctypes.data_as(_U8P),
        gt1.ctypes.data_as(_U64P), gt2.ctypes.data_as(_U64P),
        ph.ctypes.data_as(_U64P), n_ind, k, 1 if haploid else 0,
        counts.ctypes.data_as(_I64P),
    )
    nt, ns, nk, nb = (int(c) for c in counts[:4])
    try:  # the take frees the handle; anything raised before it frees it here
        tgt_var, tgt_allele, tgt_nsig = (np.empty(nt, dtype=np.int32) for _ in range(3))
        sig_nk = np.empty(ns, dtype=np.int32)
        kmer_len = np.empty(nk, dtype=np.int32)
        out_bytes = np.empty(nb, dtype=np.uint8)
        ptrs = (tgt_var.ctypes.data_as(_I32P), tgt_allele.ctypes.data_as(_I32P),
                tgt_nsig.ctypes.data_as(_I32P), sig_nk.ctypes.data_as(_I32P),
                kmer_len.ctypes.data_as(_I32P), out_bytes.ctypes.data_as(_U8P))
    except BaseException:
        lib.malva_extract_free(handle)
        raise
    lib.malva_extract_take(handle, *ptrs)
    out = (tgt_var, tgt_allele, tgt_nsig, sig_nk, kmer_len, out_bytes)
    stats = {"blocks": int(counts[5]), "units": int(counts[8]), "busy_us": int(counts[6]),
             "critical_us": int(counts[7])}
    return int(counts[4]), out, stats


def _warn_oob_allele(seq_name: str, ref_pos: int) -> None:
    from ..variants import blocks as _blocks

    if not _blocks._warned_oob_allele:
        print(
            f"[malva-tpu] warning: GT allele index beyond ALT count at "
            f"{seq_name}:{ref_pos + 1} (symbolic ALT dropped?); using REF",
            file=sys.stderr,
        )
        _blocks._warned_oob_allele = True


class _ScanView(ctypes.Structure):
    """csrc/host_kernels.cpp ScanView: one malva_vcf_scan result."""

    _fields_ = [(n, ctypes.c_int64) for n in (
        "status", "n_vars", "n_blocks", "n_lines", "n_used", "n_names", "fallback", "rec_off",
        "rec_len")] + [(n, ctypes.c_void_p) for n in (
            "buf", "line_off", "line_len", "gt_off", "gt_len", "gt_at", "pos", "ref_size",
            "min_size", "max_size", "present", "qual", "name", "al_start", "al_off", "al_bytes",
            "freq", "id_off", "id_bytes", "blk_off", "blk_name", "used", "name_off",
            "name_bytes")]


def _copy(addr, n: int, dtype) -> np.ndarray:
    """A copy of the ``n`` values of ``dtype`` at ``addr``."""
    dtype = np.dtype(dtype)
    if n <= 0 or not addr:
        return np.zeros(0, dtype=dtype)
    return np.frombuffer((ctypes.c_char * (n * dtype.itemsize)).from_address(addr),
                         dtype=dtype).copy()


class Columns:
    """One extraction batch, from either record source, as columns: the
    variants that enter blocks, in file order, and the blocks.

    ``blk_off`` holds the blocks' variant offsets and ``blk_name`` the
    contig each block's reference comes from; a variant's contig is
    ``names[name[i]]``, then its position, REF size, shortest and longest
    allele sizes, present flag and QUAL (``pos``, ``ref_size``,
    ``min_size``, ``max_size``, ``present``, ``qual``); its alleles, REF
    first, are ``al_start`` into ``al_off`` into ``al_bytes``, with their
    frequencies in ``freq``; its ID is ``id_off`` into ``id_bytes``.

    The record scanner's batch (:meth:`from_view`) also says where each
    record's line and GT region lie in the scanner's text (``line``;
    ``gt_off``, ``gt_len`` and ``gt_at``, -1 where a variant has no GT
    row), valid until its next scan, whether Python read one of its
    records (``fallback``), and the contigs ``used_out`` gains with it
    (``used``; the Python path's source adds them itself).  The Python path's batch
    (``variants/variant.py to_columns``) keeps its Variants and each one's
    GT source (``gt_src``: its record and the index of GT in its FORMAT,
    -1 where Python decodes it; None where it has no GT row)."""

    def __init__(self, names: list, variants: "list | None" = None, gt_src=None, **cols):
        self.names = names
        self.scanned = variants is None
        self._vars = variants
        self.gt_src = gt_src
        self.fallback = False
        self.__dict__.update(cols)
        self.n_vars = int(self.pos.shape[0])

    @classmethod
    def from_view(cls, v: _ScanView, names: list) -> "Columns":
        n = v.n_vars
        al_start = _copy(v.al_start, n + 1, np.int64)
        n_al = int(al_start[-1]) if n else 0
        al_off = _copy(v.al_off, n_al + 1, np.int64)
        id_off = _copy(v.id_off, n + 1, np.int64)
        return cls(
            names, blk_off=_copy(v.blk_off, v.n_blocks + 1, np.int64),
            blk_name=[names[i] for i in _copy(v.blk_name, v.n_blocks, np.int32).tolist()],
            used=[names[i] for i in _copy(v.used, v.n_used, np.int32).tolist()],
            pos=_copy(v.pos, n, np.int64), ref_size=_copy(v.ref_size, n, np.int64),
            min_size=_copy(v.min_size, n, np.int64), max_size=_copy(v.max_size, n, np.int64),
            present=_copy(v.present, n, np.uint8), qual=_copy(v.qual, n, np.float32),
            name=_copy(v.name, n, np.int32), al_start=al_start, al_off=al_off,
            al_bytes=_copy(v.al_bytes, int(al_off[-1]) if n_al else 0, np.uint8),
            freq=_copy(v.freq, n_al, np.float32), id_off=id_off,
            id_bytes=_copy(v.id_bytes, int(id_off[-1]) if n else 0, np.uint8).tobytes(),
            gt_off=_copy(v.gt_off, n, np.int64), gt_len=_copy(v.gt_len, n, np.int64),
            gt_at=_copy(v.gt_at, n, np.int64), line_off=_copy(v.line_off, n, np.int64),
            line_len=_copy(v.line_len, n, np.int64), buf=v.buf, fallback=bool(v.fallback))

    def line(self, i: int) -> bytes:
        """A scanned record ``i``'s line (until the scanner's next scan)."""
        return ctypes.string_at(self.buf + int(self.line_off[i]), int(self.line_len[i]))

    def variants(self) -> list:
        """The batch's Variants: the Python path's own; a scanned batch's
        made from its columns at the first call, on the thread that makes
        it (the consumer's)."""
        if self._vars is None:
            from ..variants.variant import from_columns

            self._vars = from_columns(self)
        return self._vars


class VcfScan:
    """The library's record scanner over one VCF (``malva_vcf_open``):
    ``scan`` runs one call, GIL released, and leaves its view; a status 0
    view is a batch (``batch``), status 1 a line for Python (``line``,
    then ``put``), status 2 a stream that failed."""

    def __init__(self, lib, handle):
        self._lib = lib
        self._h = handle
        self.view = _ScanView()
        self._names: list = []

    @classmethod
    def open(cls, path: str, n_samples: int, freq_key: str, uniform: bool, strip_chr: bool,
             keep_absent: bool, k: int) -> "VcfScan | None":
        """The scanner, or None where the library cannot take the file."""
        lib = load()
        if lib is None:
            return None
        h = lib.malva_vcf_open(os.fsencode(path), n_samples, freq_key.encode(), int(uniform),
                               int(strip_chr), int(keep_absent), k)
        return cls(lib, h) if h else None

    def scan(self, max_vars: int) -> _ScanView:
        v = self.view
        self._lib.malva_vcf_scan(self._h, max_vars, ctypes.byref(v))
        if v.n_names > len(self._names):
            off = _copy(v.name_off, v.n_names + 1, np.int64).tolist()
            blob = ctypes.string_at(v.name_bytes, off[-1])
            self._names.extend(blob[a:b].decode() for a, b in zip(off[len(self._names):-1],
                                                                   off[len(self._names) + 1:]))
        return v

    def batch(self) -> Columns:
        return Columns.from_view(self.view, self._names)

    def line(self) -> bytes:
        v = self.view
        return ctypes.string_at(v.buf + v.rec_off, v.rec_len)

    def put(self, seq_name: str, passing: bool, pos: int, ref_size: int, min_size: int) -> None:
        name = seq_name.encode()
        self._lib.malva_vcf_put(self._h, name, len(name), int(passing), pos, ref_size, min_size)

    def close(self) -> None:
        if self._h:
            self._lib.malva_vcf_close(self._h)
            self._h = None


def parse_gt_spans(base, off, ln, gt_at, n_samples: int):
    """The batched GT parse (OpenMP across records) of record regions that
    lie in one buffer: record r's sample columns are ``ln[r]`` bytes at
    ``base + off[r]``, its GT the FORMAT key at ``gt_at[r]``; ``base`` is
    an address (the scanner's text) or a uint8 array.  -> (a1, a2 (R, S)
    int32, phase (R, S) bool, ok (R,) bool), record r's rows valid where
    ``ok[r]``; None without the library."""
    lib = load()
    if lib is None:
        return None
    off, ln, gt_at = (np.ascontiguousarray(a, dtype=np.int64) for a in (off, ln, gt_at))
    R = off.shape[0]
    a1 = np.empty((R, n_samples), dtype=np.int32)
    a2 = np.empty((R, n_samples), dtype=np.int32)
    ph = np.empty((R, n_samples), dtype=np.bool_)
    ok = np.zeros(R, dtype=np.uint8)
    if R:
        lib.malva_parse_gt_spans(
            base if isinstance(base, int) else base.ctypes.data, off.ctypes.data_as(_I64P),
            ln.ctypes.data_as(_I64P), gt_at.ctypes.data_as(_I64P), R, n_samples,
            a1.ctypes.data_as(_I32P), a2.ctypes.data_as(_I32P), ph.ctypes.data_as(_U8P),
            ok.ctypes.data_as(_U8P),
        )
    return a1, a2, ph, ok.astype(bool)


def extract_columns(cols: Columns, gts, refs, k: int, haploid: bool):
    """:func:`extract_arrays` over a batch and its GT step's ``gts``
    (rows (n_vars,), -1 where a variant has no GT row; a1, a2, phase);
    ``refs`` maps each block's contig to its reference as bytes.  -> (the
    six output arrays, stats), or None without the library."""
    rows, a1, a2, ph = gts
    has = rows >= 0
    gt1 = np.zeros(cols.n_vars, dtype=np.uint64)
    gt2 = np.zeros(cols.n_vars, dtype=np.uint64)
    gph = np.zeros(cols.n_vars, dtype=np.uint64)
    if has.any():
        r = rows[has].astype(np.uint64)
        S = np.uint64(a1.shape[1])
        gt1[has] = np.uint64(a1.ctypes.data) + r * S * np.uint64(4)
        gt2[has] = np.uint64(a2.ctypes.data) + r * S * np.uint64(4)
        gph[has] = np.uint64(ph.ctypes.data) + r * S
    views = {name: np.frombuffer(refs[name], dtype=np.uint8) if refs[name] else None
             for name in set(cols.blk_name)}
    res = extract_arrays(cols.blk_off, [views[name] for name in cols.blk_name], cols.pos,
                         cols.ref_size, cols.min_size, cols.present, cols.al_start, cols.al_off,
                         cols.al_bytes, (gt1, gt2, gph), a1.shape[1] if has.any() else 0, k,
                         haploid)
    if res is None:
        return None
    oob, out, stats = res
    if oob >= 0:
        _warn_oob_allele(cols.names[cols.name[oob]], int(cols.pos[oob]))
    return out, stats


def sort_count_inplace(keys: np.ndarray):
    """sort_count variant that CONSUMES its input: (n, 2) uint64 rows are
    sorted in place (no working copy) and the result is returned as
    VIEWS into the caller's buffer — only valid until the caller drops
    or reuses it.  None when unavailable or the layout doesn't fit."""
    lib = load()
    if (lib is None or keys.ndim != 2 or keys.shape[1] != 2
            or keys.dtype != np.uint64 or not keys.flags.c_contiguous
            or not keys.flags.writeable):
        return None
    n = keys.shape[0]
    if n == 0:
        return keys, np.zeros(0, dtype=np.int64)
    cnts = np.empty(n, dtype=np.int64)
    u = lib.malva_sort_count(keys.ctypes.data_as(_U64P), n,
                             cnts.ctypes.data_as(_I64P))
    return keys[:u], cnts[:u]


_MALLOC_TUNED = False


def tune_malloc(threshold: int = (1 << 30) + 1) -> bool:
    """Raise glibc's M_MMAP_THRESHOLD so GiB-scale transient buffers
    (Bloom rank, counter planes, sort scratch) ride the brk heap and
    REUSE pages across alloc/free cycles.  Default glibc mmaps them,
    returning pages to the kernel on free — every fresh allocation then
    pays first-touch zero-page faults at ~0.4 GB/s on this VM class
    (measured: 6.4 s to touch a 1 GiB rank array; 0.15 s with reuse).
    Trade-off: freed heap pages keep RSS at the high-water mark, so this
    is opt-in from process entry points (CLI, drivers), not library
    import."""
    global _MALLOC_TUNED
    if _MALLOC_TUNED:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_MMAP_THRESHOLD = -3
        ok = bool(libc.mallopt(M_MMAP_THRESHOLD, threshold))
        _MALLOC_TUNED = ok
        return ok
    except Exception:  # pragma: no cover - non-glibc platforms
        return False
