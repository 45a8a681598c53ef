"""Headline measurement of the port: sample k-mers queried per second on one card.

Counterpart of ``bench.py``: the call-phase step (K1, ``csrc/callstep.cu``)
over a synthetic index at whole-genome fill, against a C++ replica of the
reference genotyper's per-k-mer loop on this host.

    python -m malva_tpu_torch.bench                       # cuda:0
    MALVA_BENCH_MODE=sparse python -m malva_tpu_torch.bench
    MALVA_BENCH_MACHINE=1 python -m malva_tpu_torch.bench # also every core

``bench.py``'s environment and defaults: ``MALVA_BENCH_MODE`` (``wgs``: a
1 GiB filter whose words are each the AND of 6 random words, bit density
2^-6, and a 10M-key exact map; ``sparse``: one set bit in ~10^4 words and
1M keys), ``MALVA_BENCH_LOG2_BITS`` (33), ``MALVA_BENCH_BATCH`` (2^21) and
``MALVA_BENCH_ITERS`` (10).  One run takes REPEATS timed loops and
reports all their lanes over all their wall time, each loop's rate beside
it.

The index is made on the card, as ``chip_smoke.py``'s synthetic index is:
the Bloom and context words from a seeded ``torch.Generator``, the exact
map's keys (random canonical 35-mers) and its bucket table on the host,
its mini-filter in the rank's top bits.  Each timed iteration draws its
2^21 packed contexts from a seeded generator on the card and runs K1 over
them, counters 1; one fence ends the loop.  The rate is lanes over the
loop's wall time; beside it, the sum of K1's launcher events (the kernel's
device time), which splits the host's launch time from the device's.

The baseline is ``csrc/ref_hotloop.cpp`` (the repo's ``native/
ref_hotloop.cpp``) built with g++ into ``build/bench/``, against
``csrc/xxh3_shim.cpp``, this package's XXH3 (``csrc/xxh3.cuh``), not
upstream xxHash: the JSON says so under ``baseline_hash``.  One process by
default; with ``MALVA_BENCH_MACHINE=1`` also one per core, as many as the
free memory holds (each holds about 3 GiB at 2^33 bits), rates summed.

Prints ONE JSON line with ``bench.py``'s keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``baseline_single_thread``, ``baseline_machine``,
``vs_machine``) and the card, its power limit, the device times and the
host's thread counts.  ``main(device="cpu", ...)`` runs the same loop on the
CPU with the kernels' plain versions, for the tests: its numbers are the
CPU's, and the line says ``"device": "cpu"``.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

K, REF_K = 35, 43
CSRC = Path(__file__).resolve().parent / "csrc"
KEY_CHUNK = 1 << 20  # exact-map keys made on the host per chunk
REPEATS = 3
BASELINE_KMERS = 1 << 20  # contexts of the C++ replica's loop (bench.py's)


def settings() -> dict:
    mode = os.environ.get("MALVA_BENCH_MODE", "wgs")
    if mode not in ("wgs", "sparse"):
        raise SystemExit(f"MALVA_BENCH_MODE must be wgs or sparse, not {mode!r}")
    return {"mode": mode,
            "log2_bits": int(os.environ.get("MALVA_BENCH_LOG2_BITS", "33")),
            "batch": int(os.environ.get("MALVA_BENCH_BATCH", str(1 << 21))),
            "iters": int(os.environ.get("MALVA_BENCH_ITERS", "10")),
            "n_and": 6 if mode == "wgs" else 0,
            "map_keys": 10_000_000 if mode == "wgs" else 1_000_000,
            "machine": os.environ.get("MALVA_BENCH_MACHINE", "0") == "1"}


def exact_map(n_keys: int):
    """The exact map: n_keys random canonical 35-mers (seed 0), as a
    bucket table, with the keys' XXH3 and the keys; made in chunks to
    bound host memory."""
    from .index.device import pack2bit_u32_np
    from .index.kmap_table import BucketTable
    from .ops.seq import canonical
    from .ops.xxh3 import xxh3_64

    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    packed, hashes, chunks = [], [], []
    for lo in range(0, n_keys, KEY_CHUNK):
        keys = canonical(alpha[rng.integers(0, 4, size=(min(KEY_CHUNK, n_keys - lo), K))])
        packed.append(pack2bit_u32_np(keys, K))
        hashes.append(xxh3_64(keys))
        chunks.append(keys)
    h = np.concatenate(hashes)
    return BucketTable.from_packed(np.concatenate(packed), h, K), h, np.concatenate(chunks)


def synthetic_index(device, log2_bits: int, n_and: int, n_keys: int) -> dict:
    """Bloom and context words made on ``device`` (bench.py:148-178): each
    word the AND of n_and random words, or (n_and 0) one bit in ~10^4
    words; the [word, rank | mini-filter << 28] rows; the exact map and
    its keys (uint8 ASCII rows, for contexts planted on them)."""
    from .index.device import minifilter_rows, pack_bloom_rows
    from .ops.bloom import from_u32

    gen = torch.Generator(device=device).manual_seed(0)
    W = (1 << log2_bits) // 32

    def rand_words():
        return torch.randint(-2**31, 2**31, (W,), dtype=torch.int32, device=device, generator=gen)

    def words():
        if n_and == 0:
            hit = torch.randint(0, 10000, (W,), device=device, generator=gen) == 0
            bit = torch.randint(0, 32, (W,), device=device, generator=gen)
            return torch.where(hit, torch.ones_like(bit) << bit, 0).to(torch.int32)
        w = rand_words()
        for _ in range(n_and - 1):
            w &= rand_words()
        return w

    t0 = time.perf_counter()
    bf_words, ctx_words = words(), words()
    table, h, keys = exact_map(n_keys)
    mf_rows, mf_bits = (torch.from_numpy(a).to(device) for a in minifilter_rows(h, 1 << log2_bits))
    bf_packed = pack_bloom_rows(bf_words, mf_rows, mf_bits)
    del bf_words
    last = bf_packed[-1].long() & 0xFFFFFFFF
    n_counts = int(last[1] & ((1 << 28) - 1)) + bin(int(last[0])).count("1")
    if n_counts >= 1 << 28:
        raise ValueError(f"{n_counts} counters do not fit below the mini-filter (2^28)")
    return {"bf_packed": bf_packed, "ctx_words": ctx_words, "n_counts": n_counts,
            "kmap_keys": from_u32(table.bucket_keys, device), "n_buckets": table.n_buckets,
            "keys": keys, "made_s": time.perf_counter() - t0}


def timed_loop(ix: dict, device, batch: int, iters: int, seed: int) -> dict:
    """``iters`` K1 steps over fresh contexts from a seeded generator on
    the device, one fence at the end: wall time and K1's event time."""
    from .index.device import events_ms, timing_events
    from .ops import kernels

    gen = torch.Generator(device=device).manual_seed(seed)
    counters = torch.ones(batch, dtype=torch.int32, device=device)
    state = torch.zeros(ix["n_counts"] + ix["n_buckets"] * 4, dtype=torch.int32, device=device)
    args = dict(k=K, ref_k=REF_K, size_bits=ix["bf_packed"].shape[0] * 32,
                n_buckets=ix["n_buckets"], minifilter=True)
    fence = torch.cuda.synchronize if device.type == "cuda" else (lambda *_: None)
    events = []
    fence(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        ctx = torch.randint(-2**31, 2**31, (batch, (REF_K + 15) // 16), dtype=torch.int32,
                            device=device, generator=gen)
        ev = timing_events(device)
        kernels.callstep(ix["bf_packed"], ix["ctx_words"], ix["kmap_keys"], state, ctx, counters,
                         events=ev, **args)
        if ev is not None:
            events.append(ev)
    fence(device)
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "rate": batch * iters / wall, "k1_event_ms": events_ms(events),
            "bf_updated": int((state[: ix["n_counts"]] != 0).sum())}


BASELINE_FLAGS = ("-O3", "-march=native")


def baseline_exe() -> Path:
    """The C++ replica, built at first use into build/bench/; the name
    carries a digest of its sources, flags and this CPU's model
    (-march=native builds for this CPU only)."""
    from .utils.build_dir import build_dir
    from .utils.native import _cpu_model

    srcs = [CSRC / "ref_hotloop.cpp", CSRC / "xxh3_shim.cpp", CSRC / "xxh3.cuh"]
    h = hashlib.sha256(" ".join(BASELINE_FLAGS).encode() + _cpu_model())
    for src in srcs:
        h.update(src.read_bytes())
    out = build_dir("bench")
    exe = out / f"ref_hotloop_{h.hexdigest()[:16]}"
    if not exe.exists():
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / f"{exe.name}.tmp{os.getpid()}"
        subprocess.run(["g++", *BASELINE_FLAGS, f"-I{CSRC}", "-o", str(tmp), *map(str, srcs[:2])],
                       check=True, capture_output=True, timeout=180)
        os.replace(tmp, exe)
    return exe


def _rate(out: str) -> float:
    for line in out.splitlines():
        if line.startswith("kmers_per_sec="):
            return float(line.split("=")[1])
    raise ValueError(f"no kmers_per_sec= line in {out!r}")


def baseline_argv(exe: Path, log2_bits: int, n_and: int, map_keys: int) -> list[str]:
    return [str(exe), str(min(log2_bits, 33)), str(BASELINE_KMERS), "3", str(n_and),
            str(map_keys)]


def baseline_bytes(log2_bits: int, map_keys: int) -> int:
    """What one replica process holds: its Bloom and context words, ranks
    and 16-bit counters, ~100 bytes a map key, and its contexts."""
    size = 1 << min(log2_bits, 33)
    return size // 4 + size // 16 + size // 32 + 100 * map_keys + BASELINE_KMERS * REF_K


def free_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def baseline_single(argv: list[str]) -> float:
    return _rate(subprocess.run(argv, check=True, capture_output=True, text=True,
                                timeout=900).stdout)


def baseline_machine(argv: list[str], per_process: int) -> tuple[float, int]:
    """One replica per core, as many as the free memory holds, run at
    once; (summed rate, processes)."""
    n = max(1, min(os.cpu_count() or 1, free_bytes() * 8 // 10 // per_process))
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
             for _ in range(n)]
    total = 0.0
    try:
        for p in procs:
            out, _ = p.communicate(timeout=900)
            if p.returncode != 0:
                raise RuntimeError(f"baseline process exited {p.returncode}")
            total += _rate(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return total, n


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(device: str = "cuda", log2_bits: int | None = None, map_keys: int | None = None,
         batch: int | None = None, iters: int | None = None,
         machine: bool | None = None) -> dict:
    """Run the measurement and print its JSON line (also returned).
    Arguments left None take the environment's values (``settings``)."""
    s = settings()
    for key, v in (("log2_bits", log2_bits), ("map_keys", map_keys), ("batch", batch),
                   ("iters", iters), ("machine", machine)):
        if v is not None:
            s[key] = v
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench: no CUDA device")
        dev = torch.device("cuda", dev.index or 0)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[bench] {where}, mode {s['mode']}: 2^{s['log2_bits']} bits, {s['map_keys']} map "
          f"keys, {REPEATS} x {s['iters']} iterations of {s['batch']} lanes", file=sys.stderr)

    ix = synthetic_index(dev, s["log2_bits"], s["n_and"], s["map_keys"])
    fill = ix["n_counts"] / (1 << s["log2_bits"])
    print(f"[bench] index made in {ix['made_s']:.3f} s: popcount {ix['n_counts']} (density "
          f"{fill:.3e}), {ix['n_buckets']} buckets", file=sys.stderr)
    timed_loop(ix, dev, s["batch"], 2, seed=7)  # warm-up
    runs = [timed_loop(ix, dev, s["batch"], s["iters"], seed=8 + r) for r in range(REPEATS)]
    if not all(r["bf_updated"] for r in runs):
        raise AssertionError("a timed loop updated no counter")
    rate = s["batch"] * s["iters"] * REPEATS / sum(r["wall_s"] for r in runs)
    for r in runs:
        print(f"[bench] {r['rate']:.6g} k-mers/s ({r['wall_s']:.6g} s wall); K1 launcher events "
              f"{r['k1_event_ms']} ms over {s['iters']} x {s['batch']} lanes", file=sys.stderr)
    del ix

    exe = baseline_exe()
    argv = baseline_argv(exe, s["log2_bits"], s["n_and"], s["map_keys"])
    base = baseline_single(argv)
    base_machine, n_proc = (baseline_machine(argv, baseline_bytes(s["log2_bits"], s["map_keys"]))
                            if s["machine"] else (0.0, 0))
    print(f"[bench] C++ replica ({s['mode']} fill, {s['map_keys']}-key map): {base:.6g} k-mers/s "
          f"on 1 thread; {base_machine:.6g} k-mers/s from {n_proc} processes ({os.cpu_count()} "
          f"cores)", file=sys.stderr)
    result = {
        "metric": f"call_kmers_queried_per_sec_per_chip_{s['mode']}",
        "value": rate,
        "unit": "kmers/s",
        "vs_baseline": rate / base if base > 0 else 0.0,
        "baseline_single_thread": base,
        "baseline_machine": base_machine,
        "vs_machine": rate / base_machine if base_machine > 0 else 0.0,
        "baseline_hash": "malva_tpu_torch csrc/xxh3.cuh",
        "device": dev.type,
        "card": card() if dev.type == "cuda" else None,
        "repeats": [r["rate"] for r in runs],
        "wall_s": [r["wall_s"] for r in runs],
        "k1_event_ms": [r["k1_event_ms"] for r in runs],
        "k1_device_rate": [s["batch"] * s["iters"] / (r["k1_event_ms"] / 1e3)
                           if r["k1_event_ms"] else None for r in runs],
        "lanes_per_repeat": s["batch"] * s["iters"],
        "density": fill, "map_keys": s["map_keys"], "log2_bits": s["log2_bits"],
        "baseline_single_thread_threads": 1,
        "baseline_machine_processes": n_proc,
        "host_threads": os.cpu_count(),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
