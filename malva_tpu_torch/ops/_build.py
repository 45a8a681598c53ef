"""Build and bind the CUDA kernels of ``csrc/``.

``nvcc`` compiles each kernel source for ``sm_90a`` into an object, one
process per source, all at once, and links the objects into one shared
library with a plain C interface, which ``ctypes`` loads.  The build runs
at first use, only from the sources in this package, into
``utils/build_dir.py``'s ``kernels`` directory (``build/kernels/`` in a
checkout, else the user's cache directory); the file name carries a
digest of the sources and flags, so an edited source builds anew.  A failed build raises: nothing
falls back.  ``ptxas_report`` reads each kernel's registers, stack frame
and spills from the build's ``-Xptxas -v`` output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..utils.build_dir import build_dir

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = build_dir("kernels")
SOURCES = ("callstep.cu", "ref_scan.cu", "seq_count.cu", "shard_step.cu", "route.cu")
HEADERS = ("xxh3.cuh", "lanes.cuh", "launch.cuh", "step.cuh", "route.cuh", "partition.cuh",
           "gather.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# --split-compile=0: nvcc optimizes and assembles the kernels of one source
# side by side on every core, so that callstep.cu's 30 instantiations do
# not keep the whole build waiting (chip_smoke.py logs each source's time)
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--split-compile=0", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

# the __global__ functions of SOURCES, as their mangled names contain them
KERNELS = ("callstep_kernel", "callstep_hash_kernel", "ref_scan_kernel", "window_hash_kernel",
           "seq_pack_kernel", "shard_update_kernel", "gather_update_kernel", "shard_slots_kernel",
           "route_kernel", "scan_pack_kernel", "scan_set_kernel")

_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output of the last build in this process (ptxas -v)


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(csrc: Path = CSRC) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        if (csrc / name).exists():
            h.update(name.encode())
            h.update((csrc / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side, each one's output and time into
    ``build_log``; raise with nvcc's output if any fails."""
    global build_log

    def run(cmd):
        t0 = time.perf_counter()
        p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return p, time.perf_counter() - t0

    with ThreadPoolExecutor(len(cmds)) as pool:
        done = list(pool.map(run, cmds))
    for cmd, (p, secs) in zip(cmds, done):
        build_log += f"{p.stdout}nvcc {Path(cmd[-1]).name}: {secs:.2f} s\n"
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed (rc={p.returncode}):\n{p.stdout}")


def _compile(so: Path, csrc: Path = CSRC) -> None:
    global build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.tmp{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    build_log = ""
    try:
        _run_all([[nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(csrc / s)]
                  for s, o in zip(SOURCES, objs)])
        _run_all([[nvcc(), *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, so)


def ptxas_report(log: str) -> list[dict]:
    """One entry per kernel instantiation that ptxas compiled in ``log``:
    its mangled name, which of KERNELS it is (None for any other), its
    registers, and its stack frame and spill bytes (any non-entry function
    ptxas lists after an entry counts towards that entry)."""
    out: list[dict] = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out.append({"function": name,
                        "kernel": next((k for k in KERNELS if k in name), None),
                        "registers": None, "stack": 0, "spill_stores": 0, "spill_loads": 0})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            for key, v in zip(("stack", "spill_stores", "spill_loads"), m.groups()):
                out[-1][key] += int(v)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
    return out


def library_at(csrc: Path) -> ctypes.CDLL:
    """The kernel library of another checkout's ``csrc`` (the same
    SOURCES), built into this build directory and loaded beside this
    one's, so that one process can time two versions; its functions'
    argtypes are the caller's to set."""
    so = BUILD_DIR / f"libmalva_kernels_{_digest(csrc)}.so"
    if not so.exists():
        _compile(so, csrc)
    return ctypes.CDLL(str(so))


def library(fresh: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on first use (or built anew when
    ``fresh``, so that ``build_log`` holds this build's ptxas report)."""
    global _lib
    if _lib is not None and not fresh:
        return _lib
    so = BUILD_DIR / f"libmalva_kernels_{_digest()}.so"
    if fresh or not so.exists():
        _compile(so)
    lib = ctypes.CDLL(str(so))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    sigs = {
        # the call-step launchers take (start, stop) event handles before the stream
        "malva_callstep_hash": [p, i64, i, i, i, i, p, p, p, p],
        "malva_callstep": [p, p, i64, i, i, i, p, p, p, p, i64, i64, i64, i, p, p, p],
        "malva_shard_update": [p, p, p, i64, i, i, i, p, i64, i64, p, p, i64, i64, i64, i, p, p,
                               p],
        "malva_gather_update": [p, p, p, i64, i, p, i64, i64, p, p, i64, i64, i64, i64, i64, p,
                                p, p],
        "malva_gather_update_split": [p, p, p, i64, i, p, i64, i64, p, p, i64, i64, i64, i64,
                                      i64, i, p, p, p],
        "malva_shard_update_slots": [p, i64, i64, i, i, i, p, i64, i64, p, p, i64, i64, i64, i,
                                     p, p, p],
        "malva_route_pack": [p, p, p, i64, i, i64, i64, i, p, i64, p, i64, p, p, p],
        "malva_route_probe": [p, i64, i, p, i, p, i64, p, i64, p, p, p],
        "malva_route_scratch_words": [i],
        "malva_enable_peer": [i, i],
        "malva_route_plan_col": [ctypes.c_char_p],
        "malva_slot_layout": [i],
        "malva_routed_step": [i, p, i, i, i, i, i64, i64, i64, i64, i64, i, p, p, p, p, p, p, p,
                              p, p, p, p, p, i64, i64],
        "malva_window_hash": [p, i64, i, i, p, p],
        "malva_ref_scan": [p, i64, i, i, p, p, i64, p],
        "malva_seq_pack": [p, i64, i, p, p, p],
        "malva_scan_pack": [p, i64, i, i, p, i64, i64, i, i, p, i64, p, i64, p, p, p, p, p],
        "malva_scan_set": [p, i, i64, i, p, p],
        "malva_scan_plan_col": [ctypes.c_char_p],
        "malva_sharded_scan_step": [i, p, i, i, i64, i64, i, i64, i64, i, p, p, p, p, p, p, p, p,
                                    p, p, i64],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.malva_route_scratch_words.restype = ctypes.c_int64
    _lib = lib
    return lib
