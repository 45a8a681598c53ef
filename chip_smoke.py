#!/usr/bin/env python3
"""Smoke run of malva_tpu_torch on one CUDA card: kernels, then the main path.

    python3 chip_smoke.py              # everything (needs one card)
    python3 chip_smoke.py --kernels-only

1. Prints torch's and CUDA's versions and the card's name and power limit.
2. Builds the CUDA kernels from ``malva_tpu_torch/csrc`` with nvcc.
3. Holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes, with zero tolerance (integer hashing and
   counters are exact): K1 hash-only on 2^21 packed contexts and K1 fused
   on a synthetic -b 1 index (2^33 bits at a bit density of 2^-6, a 1M-key
   exact map); K2 hash-only and scan on a 2^20-position chunk with N,
   lowercase and IUPAC bytes.  Times both with CUDA events.
4. Runs ``malva-tpu-torch run -k 35 -r 43 -b 1 -f AF`` on the chr-scale
   synthetic input (tools/make_synth_scale.py: 10 Mbp, 100k records x 50
   samples, 5x reads) with ``--backend cuda`` and, on a separate copy of
   the inputs, ``--backend host``; the VCFs must be byte-identical and
   both kernels must have launched in the cuda run.

Any failure raises and the exit code is not 0.  The last two lines are
one JSON object of kernel results and the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
K, REF_K = 35, 43
SIZE_BITS = 1 << 33          # -b 1
N_AND = 6                    # bit density 2^-6
MAP_KEYS = 1 << 20
LANES = 1 << 21
CHUNK = 1 << 20


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def max_abs_err(got, want) -> int:
    """Max |got - want| over lists of int tensors; raises unless 0."""
    err = max(int((g.to("cpu").long() - w.to("cpu").long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    if len(got) != len(want) or err != 0:
        raise AssertionError(f"kernel disagrees with its plain version: max abs err {err}")
    return err


def synthetic_index(device):
    """A -b 1 index the way bench.py:148-178 builds one: Bloom and context
    words each the AND of N_AND random words, a MAP_KEYS-key exact map of
    canonical 35-mers, and its mini-filter in the rank's top bits."""
    import torch

    from malva_tpu.index.device import pack2bit_u32_np
    from malva_tpu.index.kmap_table import BucketTable
    from malva_tpu.ops.seq import canonical
    from malva_tpu.ops.xxh3 import xxh3_64
    from malva_tpu_torch.index.device import pack_bloom_rows
    from malva_tpu_torch.ops.bloom import from_u32

    gen = torch.Generator(device=device).manual_seed(0)
    W = SIZE_BITS // 32

    def and_words():
        w = torch.randint(-2**31, 2**31, (W,), dtype=torch.int32, device=device, generator=gen)
        for _ in range(N_AND - 1):
            w &= torch.randint(-2**31, 2**31, (W,), dtype=torch.int32, device=device,
                               generator=gen)
        return w

    words, ctx_words = and_words(), and_words()
    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    keys = canonical(alpha[rng.integers(0, 4, size=(MAP_KEYS, K))])
    h = xxh3_64(keys)
    table = BucketTable.from_packed(pack2bit_u32_np(keys, K), h, K)
    kw = ((h % np.uint64(SIZE_BITS)) >> np.uint64(5)).astype(np.int64)
    mf_idx, inv = np.unique(kw, return_inverse=True)
    mf = np.zeros(mf_idx.shape[0], dtype=np.int64)
    np.bitwise_or.at(mf, inv, np.int64(1) << ((h >> np.uint64(60)) & np.uint64(3)).astype(np.int64))
    bf_packed = pack_bloom_rows(words, torch.from_numpy(mf_idx).to(device),
                                torch.from_numpy(mf).to(device))
    # counters = popcount = last rank (below the mini-filter bits) + last word's bits
    n_counts = ((int(bf_packed[-1, 1]) & ((1 << 28) - 1))
                + bin(int(bf_packed[-1, 0]) & 0xFFFFFFFF).count("1"))
    return {
        "bf_packed": bf_packed, "ctx_words": ctx_words, "n_counts": n_counts,
        "kmap_keys": from_u32(table.bucket_keys, device), "n_buckets": table.n_buckets,
        "keys": keys,
    }


def planted_contexts(keys, n_lanes: int, n_plant: int, device):
    """n_lanes random packed contexts, the first n_plant with a centre
    from the exact map (canonical contexts, like the counter's)."""
    import torch

    from malva_tpu.index.device import pack2bit_u32_np
    from malva_tpu.ops.seq import canonical
    from malva_tpu_torch.ops.bloom import from_u32

    rng = np.random.default_rng(1)
    gen = torch.Generator(device=device).manual_seed(1)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    ctx = torch.randint(-2**31, 2**31, (n_lanes, 3), dtype=torch.int32, device=device,
                        generator=gen)
    plant = alpha[rng.integers(0, 4, size=(n_plant, REF_K))]
    plant[:, 4:39] = keys[rng.integers(0, keys.shape[0], n_plant)]
    ctx[:n_plant] = from_u32(pack2bit_u32_np(canonical(plant), REF_K), device)
    counters = torch.from_numpy(rng.integers(1, 256, n_lanes).astype(np.int32)).to(device)
    return ctx, counters


def reference_chunk(device):
    import torch

    rng = np.random.default_rng(2)
    alpha = np.frombuffer(b"ACGTACGTACGTACGTNacgtnRYSWKM", dtype=np.uint8)
    seq = alpha[rng.integers(0, alpha.shape[0], CHUNK + REF_K - 1)]
    seq[: 1 << 16] = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 1 << 16)]
    return torch.from_numpy(seq).to(device)


def kernel_phase(device) -> list[dict]:
    """Every kernel of the main path against its plain version."""
    import torch

    from malva_tpu_torch.ops import kernels
    from malva_tpu_torch.ops.packed import popcount32

    results = []
    ix = synthetic_index(device)
    log(f"synthetic -b 1 index: popcount ~{ix['n_counts']}, {ix['n_buckets']} buckets")

    # K1 hash-only at 2^21 lanes, both modes of the TPU kernel
    ctx, counters = planted_contexts(ix["keys"], LANES, 1 << 16, device)
    for with_ctx in (False, True):
        got = kernels.callstep_hash(ctx, K, REF_K, with_ctx)
        want = kernels.callstep_hash_plain(ctx, K, REF_K, with_ctx)
        max_abs_err(got, want)
    log("K1 hash-only == plain (with_ctx False and True)")

    # K1 fused step on the -b 1 index
    n_state = ix["n_counts"] + ix["n_buckets"] * 4
    args = dict(k=K, ref_k=REF_K, size_bits=SIZE_BITS, n_buckets=ix["n_buckets"],
                minifilter=True)
    st_k = torch.zeros(n_state, dtype=torch.int32, device=device)
    st_p = torch.zeros_like(st_k)
    kernels.callstep(ix["bf_packed"], ix["ctx_words"], ix["kmap_keys"], st_k, ctx, counters, **args)
    kernels.callstep_plain(ix["bf_packed"], ix["ctx_words"], ix["kmap_keys"], st_p, ctx,
                           counters, **args)
    torch.cuda.synchronize()
    err1 = max_abs_err([st_k], [st_p])
    kv = st_k[ix["n_counts"]:]
    log(f"K1 fused == plain: {int((st_k[:ix['n_counts']] != 0).sum())} counters and "
        f"{int((kv != 0).sum())} map values updated")
    if not (st_k[: ix["n_counts"]] != 0).any() or not (kv != 0).any():
        raise AssertionError("K1 check touched no counter or no map value")
    scratch = torch.zeros_like(st_k)
    ms = cuda_ms(lambda: kernels.callstep(ix["bf_packed"], ix["ctx_words"], ix["kmap_keys"],
                                          scratch, ctx, counters, **args), iters=20)
    plain_ms = cuda_ms(lambda: kernels.callstep_plain(ix["bf_packed"], ix["ctx_words"],
                                                      ix["kmap_keys"], scratch, ctx, counters,
                                                      **args), iters=3, warmup=1)
    hash_ms = cuda_ms(lambda: kernels.callstep_hash(ctx, K, REF_K, False), iters=20)
    log(f"K1 fused {ms:.4f} ms, plain {plain_ms:.4f} ms, hash-only {hash_ms:.4f} ms "
        f"per {LANES} lanes")
    results.append({"name": "callstep", "route": "cuda",
                    "source": "malva_tpu_torch/csrc/callstep.cu",
                    "replaces": "malva_tpu/ops/pallas_kernels.py:125",
                    "max_abs_err": err1, "ms": ms, "plain_ms": plain_ms,
                    "lanes": LANES, "hash_only_ms": hash_ms})
    del st_k, st_p, scratch, ctx, counters

    # K2 on a 2^20-position chunk with N, lowercase and IUPAC bytes
    seq = reference_chunk(device)
    max_abs_err(kernels.window_hash(seq, CHUNK, K, REF_K),
                kernels.window_hash_plain(seq, CHUNK, K, REF_K))
    bf_words = ix["bf_packed"][:, 0].contiguous()
    ctx_k = torch.zeros_like(bf_words)
    ctx_p = torch.zeros_like(bf_words)
    kw = dict(k=K, ref_k=REF_K, size_bits=SIZE_BITS)
    kernels.ref_scan(bf_words, ctx_k, seq, CHUNK, **kw)
    kernels.ref_scan_plain(bf_words, ctx_p, seq, CHUNK, **kw)
    torch.cuda.synchronize()
    err2 = max_abs_err([ctx_k], [ctx_p])
    n_bits = int(popcount32(ctx_k.long() & 0xFFFFFFFF).sum())
    if n_bits == 0:
        raise AssertionError("K2 check set no context bit")
    ms = cuda_ms(lambda: kernels.ref_scan(bf_words, ctx_k, seq, CHUNK, **kw), iters=20)
    plain_ms = cuda_ms(lambda: kernels.ref_scan_plain(bf_words, ctx_p, seq, CHUNK, **kw),
                       iters=3, warmup=1)
    log(f"K2 scan == plain ({n_bits} context bits); scan {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"per {CHUNK} positions")
    results.append({"name": "ref_scan", "route": "cuda",
                    "source": "malva_tpu_torch/csrc/ref_scan.cu",
                    "replaces": "malva_tpu/ops/pallas_kernels.py:222",
                    "max_abs_err": err2, "ms": ms, "plain_ms": plain_ms,
                    "positions": CHUNK})
    return results


class _Tee(io.TextIOBase):
    """stderr that is also kept, to read the phase walls back."""

    def __init__(self, real):
        self.real, self.buf = real, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.real.write(s)

    def flush(self):
        self.real.flush()


def run_leg(backend: str, src: str, work: str) -> tuple[str, str]:
    """``run`` on a private copy of the inputs -> (vcf path, stderr)."""
    from malva_tpu_torch import cli

    os.makedirs(work)
    for name in ("synth.fa", "synth.vcf", "synth.fq"):
        shutil.copy(os.path.join(src, name), os.path.join(work, name))
    vcf = os.path.join(work, "out.vcf")
    tee = _Tee(sys.stderr)
    t0 = time.perf_counter()
    with open(vcf, "w") as out, contextlib.redirect_stderr(tee):
        rc = cli.main(["run", "--backend", backend, "-k", str(K), "-r", str(REF_K), "-b", "1",
                       "-f", "AF", *(os.path.join(work, n) for n in
                                     ("synth.fa", "synth.vcf", "synth.fq"))], out=out)
    if rc != 0:
        raise RuntimeError(f"run --backend {backend} exited {rc}")
    log(f"run --backend {backend}: {time.perf_counter() - t0:.6g} s wall")
    return vcf, tee.buf.getvalue()


def phase_walls(stderr: str) -> dict:
    """PhaseTimer walls by phase; the index pass's progress heartbeats
    ("Processed N variants") are summed into one entry."""
    walls: dict[str, float] = {}
    for m in re.finditer(r"\[malva-tpu-torch/([^\]]+)\] Execution Time ([0-9.e+-]+)s", stderr):
        name = re.sub(r"^Processed \d+ variants$", "Processed variants (heartbeats)", m.group(1))
        walls[name] = round(walls.get(name, 0.0) + float(m.group(2)), 6)
    return walls


def main_path_phase() -> dict:
    from malva_tpu_torch.ops import kernels

    tmp = tempfile.mkdtemp(prefix="malva_smoke_")
    try:
        src = os.path.join(tmp, "in")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, os.path.join(REPO, "tools", "make_synth_scale.py"), src,
                        "--mbp", "10", "--variants", "100000", "--samples", "50",
                        "--coverage", "5", "--seed", "7"], check=True)
        log(f"chr-scale input generated in {time.perf_counter() - t0:.6g} s")

        kernels.reset_launches()
        vcf_cuda, err_cuda = run_leg("cuda", src, os.path.join(tmp, "cuda"))
        launches = dict(kernels.LAUNCHES)
        vcf_host, err_host = run_leg("host", src, os.path.join(tmp, "host"))

        a, b = open(vcf_cuda, "rb").read(), open(vcf_host, "rb").read()
        if a != b:
            raise AssertionError(f"cuda and host VCFs differ ({len(a)} vs {len(b)} bytes)")
        n_rec = sum(1 for ln in a.splitlines() if not ln.startswith(b"#"))
        if n_rec < 50000:
            raise AssertionError(f"only {n_rec} VCF records")
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"kernel {name} did not launch in the cuda run")
        walls = {"cuda": phase_walls(err_cuda), "host": phase_walls(err_host)}
        m = re.search(r"call step: (\d+) distinct k-mers in (\d+) steps, "
                      r"kernel time ([0-9.e+-]+) ms", err_cuda)
        if m is None:
            raise AssertionError("the cuda run logged no call-step line")
        rows, ms = int(m.group(1)), float(m.group(3))
        log(f"VCFs byte-identical ({n_rec} records); launches {launches}")
        log(f"phase walls in s: {json.dumps(walls)}")
        log(f"call step: {rows} distinct k-mers, {ms} ms kernel time, "
            f"{rows / (ms / 1e3):.6g} k-mers/s")
        return {"launches": launches, "records": n_rec, "distinct_kmers": rows,
                "call_kernel_ms": ms, "walls": walls}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ensure_native() -> str:
    """Build the native host library for this machine and load it: the
    Makefile's build, or, where the compiler has no OpenMP runtime, the
    same flags without -fopenmp (its loops then run on one thread; the
    results are identical).  Without the library the host layers fall back
    to Python and the chr-scale run is several times slower."""
    from malva_tpu.utils import native

    nd = os.path.join(REPO, "native")
    try:
        if subprocess.run(["make", "-C", nd], capture_output=True).returncode == 0:
            note = "Makefile build"
        else:
            flags = "-O3 -march=native -ffp-contract=off -std=c++17 -fPIC -Wall"
            r = subprocess.run(["make", "-C", nd, f"CXXFLAGS={flags}"], capture_output=True,
                               text=True)
            note = ("built without OpenMP" if r.returncode == 0
                    else f"build failed: {r.stderr.strip()[-300:]}")
    except OSError as e:
        note = f"make not runnable: {e}"
    return f"{'loaded' if native.load() is not None else 'NOT loaded'} ({note})"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (no main-path run, no ok line)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: nothing to check")
        return 1
    sys.path.insert(0, REPO)
    try:
        from malva_tpu_torch.ops import _build
    except ImportError as e:
        log(f"the malva_tpu_torch package is missing beside this script ({e})")
        return 1
    os.environ.setdefault("MALVA_SPILL_SHM", "0")  # keep the spill inside TMPDIR

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {smi}", flush=True)
    log(f"native host library: {ensure_native()}")

    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built in {time.perf_counter() - t0:.6g} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"nvcc: {line.strip()}")

    results = kernel_phase(torch.device("cuda"))
    main = None if args.kernels_only else main_path_phase()
    for r in results:
        r["launches"] = main["launches"][r["name"]] if main else None
    print(smi, flush=True)
    print(json.dumps({"kernels": results}), flush=True)
    if args.kernels_only:
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
