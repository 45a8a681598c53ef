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

The results do not depend on the thread count.  One stderr line says
which form was built and on how many threads its loops run
(``malva_threads()``).  If no library builds or loads, every caller falls
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


def _forms(cxx: str, out: Path) -> list:
    """(form, note, commands) of each build form, in the order tried."""
    def define(form: str) -> str:
        return f'-DMALVA_BUILD_FORM="{form}"'

    forms = [("a", "with OpenMP (-fopenmp)",
              [[cxx, *CXXFLAGS, "-fopenmp", define("a"), "-shared", "-o", str(out),
                str(SOURCE)]])]
    gomp = torch_gomp()
    if gomp is not None:
        obj = out.with_suffix(".o")
        forms.append(("b", f"with OpenMP (-fopenmp, linked against torch's {gomp})",
                      [[cxx, *CXXFLAGS, "-fopenmp", define("b"), "-c", "-o", str(obj),
                        str(SOURCE)],
                       [cxx, "-shared", "-o", str(out), str(obj), str(gomp),
                        f"-Wl,-rpath,{gomp.parent}"]]))
    forms.append(("none", "without OpenMP (no OpenMP runtime for g++ here; its loops run on "
                          "one thread)",
                  [[cxx, *CXXFLAGS, define("none"), "-shared", "-o", str(out), str(SOURCE)]]))
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
        try:
            for form, note, cmds in _forms(os.environ.get("CXX", "g++"), tmp):
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
                              f"{form}, {threads} thread{'s' * (threads != 1)}: {so}",
                              file=sys.stderr)
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
        lib.malva_combs.restype = ctypes.c_int64
        lib.malva_combs.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64,
        ]
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
        lib.malva_parse_gt_batch.restype = None
        lib.malva_parse_gt_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.malva_extract_group.restype = ctypes.c_int64
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p_ = ctypes.POINTER(ctypes.c_int64)
        lib.malva_extract_group.argtypes = [
            ctypes.c_int64, i64p_, u64p, i64p_,           # blocks, refs
            i64p_, i64p_, i64p_, u8p,                     # pos/size/min/present
            i64p_, i64p_, u8p,                            # alleles
            u64p, u64p, u64p, ctypes.c_int64,             # gt ptrs, n_ind
            ctypes.c_int64, ctypes.c_int,                 # k, haploid
            i32p, i32p, i32p, ctypes.c_int64,             # targets
            i32p, ctypes.c_int64,                         # sig_nk
            i32p, ctypes.c_int64,                         # kmer_len
            u8p, ctypes.c_int64,                          # bytes
            i64p_,                                        # out_counts
        ]
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


class CombsNative:
    """Reusable buffers + call wrapper for malva_combs.  One instance is
    shared across blocks (blocks.VB._native_engine); ``set_block`` caches
    the per-block array pointers so the per-variant call does no ctypes
    casts (data_as was ~1.5 s of pure overhead on a 70k-block VCF)."""

    def __init__(self, lib):
        self.lib = lib
        self.cap_idx = 1 << 16
        self.cap_combs = 1 << 12
        self._alloc()
        self._blk = None

    def _alloc(self):
        i64p = ctypes.POINTER(ctypes.c_int64)
        self.out_idx = np.zeros(self.cap_idx, dtype=np.int32)
        self.out_off = np.zeros(self.cap_combs + 1, dtype=np.int64)
        self._out_idx_p = self.out_idx.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32))
        self._out_off_p = self.out_off.ctypes.data_as(i64p)

    def set_block(self, pos, size, min_size, present):
        """Pin one block's variant arrays (kept alive here) and cache
        their pointers for the per-variant combs() calls."""
        i64p = ctypes.POINTER(ctypes.c_int64)
        self._blk = (pos, size, min_size, present)  # keep buffers alive
        self._pos_p = pos.ctypes.data_as(i64p)
        self._size_p = size.ctypes.data_as(i64p)
        self._min_p = min_size.ctypes.data_as(i64p)
        self._pres_p = present.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        self._n = len(pos)

    def combs(self, center: int, k: int):
        """Returns list[list[int]] of combinations for the set_block
        arrays, or None on overflow (caller falls back to Python)."""
        while True:
            n = self.lib.malva_combs(
                self._pos_p, self._size_p, self._min_p, self._pres_p,
                self._n, center, k,
                self._out_idx_p, self._out_off_p,
                self.cap_idx, self.cap_combs,
            )
            if n >= 0:
                off = self.out_off
                idx = self.out_idx
                return [idx[off[c] : off[c + 1]].tolist() for c in range(n)]
            if self.cap_idx > 1 << 26:
                return None  # genuinely explosive block: let Python handle
            self.cap_idx <<= 2
            self.cap_combs <<= 2
            self._alloc()


_I32P = ctypes.POINTER(ctypes.c_int32)


def extract_group(blocks, k: int, haploid: bool):
    """Native signature extraction over a group of variant blocks (the
    full blocks.VB.extract_kmers, reference var_block.hpp:95-219, OpenMP
    across blocks).  ``blocks`` is [(variants, ref_bytes), ...]; returns
    (tgt_var, tgt_allele, tgt_nsig, sig_nk, kmer_len, bytes_u8) with
    tgt_var indexing the concatenated variant list, or None when the
    library is unavailable / the group needs the Python path."""
    lib = load()
    if lib is None or not blocks:
        return None
    n_blocks = len(blocks)
    blk_off = np.zeros(n_blocks + 1, dtype=np.int64)
    ref_ptrs = np.zeros(n_blocks, dtype=np.uint64)
    ref_lens = np.zeros(n_blocks, dtype=np.int64)
    keep_alive = []
    all_vars = []
    for b, (variants, ref_bytes) in enumerate(blocks):
        blk_off[b + 1] = blk_off[b] + len(variants)
        rv = np.frombuffer(ref_bytes, dtype=np.uint8) if ref_bytes else np.zeros(0, np.uint8)
        keep_alive.append(rv)
        ref_ptrs[b] = rv.ctypes.data if rv.size else 0
        ref_lens[b] = rv.size
        all_vars.extend(variants)
    nv = len(all_vars)
    pos = np.fromiter((v.ref_pos for v in all_vars), np.int64, nv)
    size = np.fromiter((v.ref_size for v in all_vars), np.int64, nv)
    mins = np.fromiter((v.min_size for v in all_vars), np.int64, nv)
    present = np.fromiter((v.is_present for v in all_vars), np.uint8, nv)

    al_list = []
    na = np.empty(nv, dtype=np.int64)
    for i, v in enumerate(all_vars):
        al_list.append(v.ref_sub)
        al_list.extend(v.alts)
        na[i] = 1 + len(v.alts)
    al_start = np.zeros(nv + 1, dtype=np.int64)
    np.cumsum(na, out=al_start[1:])
    n_all = int(al_start[-1])
    al_off = np.zeros(n_all + 1, dtype=np.int64)
    np.cumsum(np.fromiter((len(a) for a in al_list), np.int64, n_all),
              out=al_off[1:])
    al_bytes = np.frombuffer(b"".join(al_list), dtype=np.uint8)
    if al_bytes.size == 0:
        al_bytes = np.zeros(1, dtype=np.uint8)

    gt1 = np.zeros(nv, dtype=np.uint64)
    gt2 = np.zeros(nv, dtype=np.uint64)
    ph = np.zeros(nv, dtype=np.uint64)
    n_ind = -1
    for i, v in enumerate(all_vars):
        if not v.is_present:
            continue
        a1, a2, p = v.gt_a1, v.gt_a2, v.phase
        if a1.shape[0] == 0:
            continue
        if (a1.dtype != np.int32 or a2.dtype != np.int32
                or p.dtype != np.bool_ or not a1.flags.c_contiguous
                or not a2.flags.c_contiguous or not p.flags.c_contiguous):
            return None
        if n_ind < 0:
            n_ind = a1.shape[0]
        elif a1.shape[0] != n_ind:
            return None  # inconsistent sample counts: Python path
        # __array_interface__ avoids building a ctypes view per array
        # (~1us each; three per variant adds ~0.3s per 100k records)
        gt1[i] = a1.__array_interface__["data"][0]
        gt2[i] = a2.__array_interface__["data"][0]
        ph[i] = p.__array_interface__["data"][0]
    if n_ind < 0:
        n_ind = 0
    else:
        # a present variant without GT arrays would KeyError in the
        # Python path too; native treats it as absent — keep paths equal
        for i, v in enumerate(all_vars):
            if v.is_present and gt1[i] == 0:
                return None

    cap_tgt = 4 * nv + 64
    cap_sig = 8 * nv + 64
    cap_kmer = 16 * nv + 64
    cap_bytes = cap_kmer * (k + 1)
    counts = np.zeros(5, dtype=np.int64)
    for _ in range(2):
        tgt_var = np.empty(cap_tgt, dtype=np.int32)
        tgt_allele = np.empty(cap_tgt, dtype=np.int32)
        tgt_nsig = np.empty(cap_tgt, dtype=np.int32)
        sig_nk = np.empty(cap_sig, dtype=np.int32)
        kmer_len = np.empty(cap_kmer, dtype=np.int32)
        out_bytes = np.empty(max(cap_bytes, 1), dtype=np.uint8)
        rc = lib.malva_extract_group(
            n_blocks, blk_off.ctypes.data_as(_I64P),
            ref_ptrs.ctypes.data_as(_U64P), ref_lens.ctypes.data_as(_I64P),
            pos.ctypes.data_as(_I64P), size.ctypes.data_as(_I64P),
            mins.ctypes.data_as(_I64P), present.ctypes.data_as(_U8P),
            al_start.ctypes.data_as(_I64P), al_off.ctypes.data_as(_I64P),
            al_bytes.ctypes.data_as(_U8P),
            gt1.ctypes.data_as(_U64P), gt2.ctypes.data_as(_U64P),
            ph.ctypes.data_as(_U64P), n_ind, k, 1 if haploid else 0,
            tgt_var.ctypes.data_as(_I32P), tgt_allele.ctypes.data_as(_I32P),
            tgt_nsig.ctypes.data_as(_I32P), cap_tgt,
            sig_nk.ctypes.data_as(_I32P), cap_sig,
            kmer_len.ctypes.data_as(_I32P), cap_kmer,
            out_bytes.ctypes.data_as(_U8P), cap_bytes,
            counts.ctypes.data_as(_I64P),
        )
        if rc == 0:
            if counts[4] >= 0:
                _warn_oob_allele(all_vars[int(counts[4])])
            nt, ns, nk, nb = (int(counts[0]), int(counts[1]), int(counts[2]),
                              int(counts[3]))
            return (tgt_var[:nt], tgt_allele[:nt], tgt_nsig[:nt],
                    sig_nk[:ns], kmer_len[:nk], out_bytes[:nb])
        # counts are exact even on overflow: retry with exact capacities
        cap_tgt, cap_sig, cap_kmer, cap_bytes = (
            int(counts[0]), int(counts[1]), int(counts[2]), int(counts[3]))
    return None  # pragma: no cover - second pass has exact capacity


def _warn_oob_allele(v) -> None:
    from ..variants import blocks as _blocks

    if not _blocks._warned_oob_allele:
        print(
            f"[malva-tpu] warning: GT allele index beyond ALT count at "
            f"{v.seq_name}:{v.ref_pos + 1} (symbolic ALT dropped?); using REF",
            file=sys.stderr,
        )
        _blocks._warned_oob_allele = True


def parse_gt_batch(regions: list, gt_ats: list, n_samples: int):
    """Batched GT parse + fused htslib decode over many records (OpenMP
    across records).  -> (a1 (R,S) i32, a2 (R,S) i32, phase (R,S) bool,
    ok (R,) bool) with per-record rows valid where ok; None when the
    library is unavailable."""
    lib = load()
    if lib is None or n_samples == 0 or not regions:
        return None
    buf = np.frombuffer(b"".join(regions), dtype=np.uint8)
    off = np.zeros(len(regions) + 1, dtype=np.int64)
    np.cumsum(np.fromiter((len(r) for r in regions), np.int64, len(regions)),
              out=off[1:])
    ga = np.asarray(gt_ats, dtype=np.int64)
    R = len(regions)
    a1 = np.empty((R, n_samples), dtype=np.int32)
    a2 = np.empty((R, n_samples), dtype=np.int32)
    ph = np.empty((R, n_samples), dtype=np.bool_)
    ok = np.zeros(R, dtype=np.uint8)
    if buf.size == 0:
        buf = np.zeros(1, dtype=np.uint8)
    lib.malva_parse_gt_batch(
        buf.ctypes.data_as(_U8P), off.ctypes.data_as(_I64P),
        ga.ctypes.data_as(_I64P), R, n_samples,
        a1.ctypes.data_as(_I32P), a2.ctypes.data_as(_I32P),
        ph.ctypes.data_as(_U8P), ok.ctypes.data_as(_U8P),
    )
    return a1, a2, ph, ok.astype(bool)


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
