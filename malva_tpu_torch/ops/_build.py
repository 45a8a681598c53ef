"""Build and bind the CUDA kernels of ``csrc/``.

``nvcc`` compiles the kernels for ``sm_90a`` into a shared library with a
plain C interface, which ``ctypes`` loads.  The build runs at first use,
only from the sources in this package, into ``build/kernels/`` at the
repository root; the file name carries a digest of the sources and
flags, so an edited source builds anew.  A failed build raises: nothing
falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
SOURCES = ("callstep.cu", "ref_scan.cu")
HEADERS = ("xxh3.cuh", "lanes.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output of the last build in this process (ptxas -v)


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(so: Path) -> None:
    global build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc={res.returncode}):\n{build_log}")
    os.replace(tmp, so)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    so = BUILD_DIR / f"libmalva_kernels_{_digest()}.so"
    if not so.exists():
        _compile(so)
    lib = ctypes.CDLL(str(so))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    sigs = {
        "malva_callstep_hash": [p, i64, i, i, i, i, p, p],
        "malva_callstep": [p, p, i64, i, i, i, p, p, p, p, i64, i64, i64, i, p],
        "malva_window_hash": [p, i64, i, i, p, p],
        "malva_ref_scan": [p, i64, i, i, p, p, i64, p],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib
