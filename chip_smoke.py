#!/usr/bin/env python3
"""Smoke run of malva_tpu_torch on one CUDA card: kernels, then the main paths.

    python3 chip_smoke.py              # everything (needs one card)
    python3 chip_smoke.py --kernels-only
    python3 chip_smoke.py --kernels-only --parent DIR   # and DIR's kernels in turns

1. Prints torch's and CUDA's versions and the card's name and power limit.
   Builds the port's native host library from its own source
   (``malva_tpu_torch/csrc/host_kernels.cpp``) and fails unless it loads
   and, on a host with more than one core, runs its loops on more than
   one thread; logs its build form and thread count.
2. Builds the CUDA kernels from ``malva_tpu_torch/csrc`` with nvcc, one
   process per source, always anew, and fails unless ptxas reports a
   0-byte stack frame and no spill store or load for every instantiation
   of K1-K9 (K4's slot entry included).
3. Holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes, with zero tolerance (integer hashing, keys and
   counters are exact): K1 hash-only on 2^21 packed contexts and K1 fused
   on a synthetic -b 1 index (2^33 bits at a bit density of 2^-6, a 1M-key
   exact map); K2 hash-only and scan on a 2^20-position chunk with N,
   lowercase and IUPAC bytes, and again on one shaped like the run's
   reference (uppercase ACGT, N runs, IUPAC codes at 1e-4); K4 on shard 0
   of that index split 4 ways (its rows with the mini-filter of its own
   map keys, and again without it), with 2^21 lanes routed to it, a
   quarter centred on its map keys, beside torch's gather of its rows; K5
   on shard 0 of that index cut 4 ways by bucket range (rows without a
   mini-filter, the shard's range of the one global bucket table) over
   2^21 gathered lanes, a quarter centred on map keys, with random merged
   "known" flags, beside torch's gather of the owned lanes' rows; the
   routed step's partitions on 4 virtual shards over 2^21 lanes of that
   index cut into 4 source slices: K6 (route_pack) on each slice, K7
   (route_probe) on each owner, K4's slot entry on shard 0 over the hop-2
   blocks written for it (slot blocks, headers, tallies and the sorted
   overflow lists bit-identical), and again over the hop-2 blocks of a
   mix like the run's (2^16 of the 2^21 lanes on map keys), each mix with
   torch's gather of its live rows' Bloom rows timed beside it and the
   probe's bucket reads in its bound; then K6 and K7 alone at D = 1, 3, 4
   and 16 with owners spread, clumped, all to one shard and none live,
   from one lane to 2^22 (2048 tiles, more than the card holds at once),
   each case launched twice on one scratch, which each launch must leave
   zeroed (with ``--parent DIR``, the kernels of the checkout at DIR, built
   from its sources, are timed in turns with this one's on the same
   inputs: K4's slot entry at both mixes, K6, K7, K8 and K9); the sharded
   context scan's K8 (scan_pack, one launch: K2's tiles partition their
   hits by owner into slot blocks) on each of 4 slices of 2^20 positions
   of a reference-shaped contig, its launches counted from a profiler
   trace, K2's scan timed on the same slice, and K9 (scan_set) on each
   owner over the blocks written for it (blocks, tallies and context words
   bit-identical), then K8 at D = 1, 3, 4 and 16 with hits spread,
   clumped, on one owner and none, from 1 to 2^22 positions, and with
   every position a hit over 2^22, with slots that overflow, each case
   launched twice on one scratch; then the scan alone on a 2^28-position
   contig, the one-card
   scan against the sharded scan on 4 virtual shards, in turns (equal
   words, no host read in the chunks); K3 on a
   2^25-window read chunk (reads joined
   by 0xFF, with N, lowercase and reads shorter than ref_k) and on a
   short ragged chunk at each ref_k of
   K3_REF_KS (IUPAC codes, palindromes, a length that is not a whole
   number of tiles, an unaligned start), and the whole device sort-count
   step against the host counter's sort-count of the same windows.  Times
   each with CUDA events over calls the host has queued ahead (the card
   spins first), beside its bound: the larger of the bytes it
   must move over the device memory rate and the least integer
   instructions its function needs (rolling canonical codes, codes to
   ASCII four bytes at a time, XXH3; the hashes only where this run's
   Bloom bits are set) over the card's instruction issue rate at its
   maximum SM clock.  Then K1 steps of 2^20 lanes timed by the events K1's C
   launcher records, quiet and with two Python threads spinning: the busy
   mean must stay within 2x the quiet mean.  Then the f32 genotype model
   on 2^20 seeded variants, on the card and on the CPU.
4. Runs ``malva-tpu-torch run -k 35 -r 43 -b 1 -f AF`` on the chr-scale
   synthetic input (tools/make_synth_scale.py: 10 Mbp, 100k records x 50
   samples, 5x reads) with ``--backend cuda`` and, on a separate copy of
   the inputs, ``--backend host``; the VCFs must be byte-identical, K1-K3
   must have launched in the cuda run (the reads are counted on the card,
   with no host counting producer), and its logged call-step time must be
   under 10 ms; its index upload is logged in four parts (bucket table,
   mini-filter, copies, packing on the card), with the variant pass and
   pass 2 beside the native library's thread count.  Then the cuda run
   once more on a third copy with
   ``--spill-dir``: the device spill counter, the same kernels, and the
   host run's VCF.
5. Runs ``batch`` over the 5x reads and a 3x read set of the same genome
   and VCF, with ``--backend cuda`` and ``--backend host``: per-sample
   VCFs byte-identical, the 5x one equal to the ``run`` VCF, K1-K3
   launched and the device index uploaded once in the cuda leg.  The cuda
   leg runs with ``--profile-dir``; its trace gives the device time of
   each kernel and the device's busy share of the leg.
6. The sharded path on 4 virtual shards of the card
   (``make_mesh(devices=[cuda:0] * 4)``): ``build_index`` and ``call`` on
   the chr-scale input, then ``call_batch`` over the 5x and 3x reads on
   that index; each VCF equal to its host leg's, K1-K4 launched, the
   sharded context scan and call-step lines logged, K6, K7 and K4's slot
   entry launched; between them the
   all-gather design on the run's index (``apply_sample_counts_sharded(...,
   routed=False)`` over the reads counted again on the card): its
   counters equal to the routed session's, K1 and K5 launched, and the VCF
   genotyped from them equal to the host run's; then the one-card
   index upload of that chr-scale index alone, in its four parts.  Then
   ``python -m malva_tpu_torch.run_distributed`` in two processes (gloo)
   with the 5x reads split in two: rank 0's VCF equal to the host run's.
   With ``--parent DIR``, the scan alone on 4 virtual shards and the
   chr-scale sharded run from both checkouts, each in its own process, in
   turns: the scan's walls and K4's slot entry's time a launch on the run.
   Then ``graft_entry.dryrun_multichip(4, [cuda:0] * 4)``.  On a host with
   two cards or more (``nvidia-smi -L``), the real-card leg: the chr-scale
   ``run --backend cuda`` with every card visible (the default route
   shards over all of them), under ``CUDA_VISIBLE_DEVICES=0`` and, with
   three cards or more, on the first two, each in its own process (``malva_tpu_torch/tools/multicard_run.py run_once``):
   both VCFs equal to the host run's, the sharded context scan's line with
   no host read in its chunks, the walls, phases and the sharded path's
   scan, step and card start-up lines printed.  On one card it
   logs one line saying the leg needs two.  This process itself keeps to
   the first card there (``CUDA_VISIBLE_DEVICES`` set before CUDA starts),
   so that every other leg runs as on a one-card host.
7. ``python -m malva_tpu_torch.tools.scaling_mesh`` at 2^33 bits and a
   2^21 batch, both designs at D = 1, 2, 4 virtual shards (each run must
   leave the same state), and ``python -m malva_tpu_torch.bench`` (wgs,
   the single-thread C++ baseline), each in its own process.

Any failure raises and the exit code is not 0.  The last lines are the
phase walls, the bench's JSON line, the card's name and power limit, one
JSON object of kernel results and the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import argparse
import contextlib
import filecmp
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
K, REF_K = 35, 43
SIZE_BITS = 1 << 33          # -b 1
N_AND = 6                    # bit density 2^-6
MAP_KEYS = 1 << 20
LANES = 1 << 21
CHUNK = 1 << 20
WINDOWS = 1 << 25            # K3: the counter's chunk_kmers
VARIANTS = 1 << 20           # genotype model
SHARDS = 4                   # virtual shards of the one card
ROUTED = 1 << 21             # K4: lanes routed to one shard
MIN_RECORDS = 50000          # VCF records the chr-scale run must give
SYNTH = ["--mbp", "10", "--variants", "100000", "--samples", "50", "--seed", "7"]
K3_REF_KS = (15, 31, 32, 33, 43, 63, 64, 65, 96)  # K3's short ragged chunks
K3_TILE = 8192               # csrc/seq_count.cu kTile
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
ISSUE_LANES_PER_SM = 128     # Hopper: 4 warp instructions issued per SM and clock
SLEEP_CYCLES_PER_MS = 2_000_000  # torch.cuda._sleep: at most 2 GHz, so at least 1 ms


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events after a warm-up.
    The card first spins for 0.1 ms a call (torch.cuda._sleep), so that
    the host queues every call before the first runs: the events then
    hold the calls back to back, without the host's time to issue them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_MS // 10 * iters)
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


def issue_peak() -> float:
    """Integer instructions per second of the card: SMs x 128 lanes x its
    maximum SM clock (nvidia-smi).  Each of an SM's four schedulers issues
    one warp instruction a clock; LOP3, IADD3, SHF and ISETP go to the ALU
    pipe (64 lanes an SM), IMAD to the FMA pipe (64 more), so no mix of
    them issues faster.  Counted as 2 flops an FMA, the same rate is the
    data sheet's 67 TFLOP/s of float32."""
    import torch

    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * ISSUE_LANES_PER_SM * mhz * 1e6


def xxh3_ops(length: int) -> int:
    """32-bit integer instructions XXH3_64 needs at the least for 17 <=
    length <= 128 (csrc/xxh3.cuh), on input already in 32-bit words: 2 *
    ceil(length / 32) mix16 rounds of 19 (two 64-bit XORs with the secret,
    the 64 x 64 -> 128-bit product folded to 64 bits, the 64-bit add into
    the accumulator), 14 for the length seed and the avalanche."""
    return 19 * 2 * -(-length // 32) + 14


def ascii_ops(n: int) -> int:
    """ASCII words of n bases from their 2-bit codes: two instructions per
    four bases (a byte of codes picks one word of a 256-word table)."""
    return 2 * -(-n // 4)


def canonical_packed_ops(n: int) -> int:
    """Canonical form of n packed bases held in registers, 12 per 16-base
    word: 2 to extract it from the context, 6 for the reverse complement
    (bit reversal, pair swap, realignment), 3 for the compare and 1 for
    the select."""
    return 12 * -(-n // 16)


def rolling_ops(n: int) -> int:
    """One base pushed into the rolling canonical key of an n-base window,
    and the key read (csrc/lanes.cuh RollingKey): a quarter of
    base_codes4's 15 for the byte, 4 per 32-bit word and 6 for the push,
    3 per 32-bit word, 2 per 64-bit word and 2 for the key."""
    n16, w = -(-n // 16), -(-n // 32)
    return 4 + 4 * n16 + 6 + 3 * n16 + 2 * w + 2


def bloom_hits(hi, lo, words) -> int:
    """Lanes whose hash (hi, lo, int64 halves) has its bit set in the
    Bloom words (int32)."""
    from malva_tpu_torch.ops.xxh3 import xxh3_mod_size

    word, bit = xxh3_mod_size(hi, lo, SIZE_BITS)
    return int(((words[word].long() >> bit) & 1).sum())


def bound(n_bytes: float, n_ops: float, peak_ops: float) -> tuple[float, str]:
    """(least time in ms, what sets it): the bytes the function must move
    over the device memory rate, or its integer instructions over the
    issue rate, whichever is longer."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synthetic_index(device):
    """A -b 1 index the way bench.py:148-178 builds one (the port's bench
    builds it): Bloom and context words each the AND of N_AND random
    words, a MAP_KEYS-key exact map of canonical 35-mers, and its
    mini-filter in the rank's top bits."""
    from malva_tpu_torch.bench import synthetic_index as bench_index

    return bench_index(device, SIZE_BITS.bit_length() - 1, N_AND, MAP_KEYS)


def planted_contexts(keys, n_lanes: int, n_plant: int, device):
    """n_lanes random packed contexts, the first n_plant with a centre
    from the exact map (canonical contexts, like the counter's)."""
    import torch

    from malva_tpu_torch.index.device import pack2bit_u32_np
    from malva_tpu_torch.ops.bloom import from_u32
    from malva_tpu_torch.ops.seq import canonical

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


def main_path_chunk(device):
    """CHUNK + REF_K - 1 bytes shaped like the run's reference chunks
    (the FASTA loader uppercases): ACGT with runs of N and IUPAC codes at
    a rate of 1e-4, from a seed."""
    import torch

    rng = np.random.default_rng(6)
    n = CHUNK + REF_K - 1
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, n)]
    for start in rng.integers(0, n, 4):
        seq[start : start + int(rng.integers(n // 1000, n // 50))] = ord("N")
    iupac = rng.random(n) < 1e-4
    seq[iupac] = np.frombuffer(b"RYSWKMBDHV", dtype=np.uint8)[rng.integers(0, 10, int(iupac.sum()))]
    return torch.from_numpy(seq).to(device)


def kernel_phase(device, parent=None) -> list[dict]:
    """Every kernel of the main path against its plain version."""
    import torch

    from malva_tpu_torch.ops import kernels
    from malva_tpu_torch.ops.xxh3 import xxh3_mod_size

    results = []
    peak = issue_peak()
    log(f"issue rate: {peak:.6g} instructions/s (SMs x {ISSUE_LANES_PER_SM} x max SM clock)")
    ix = synthetic_index(device)
    log(f"synthetic -b 1 index: popcount ~{ix['n_counts']}, {ix['n_buckets']} buckets")

    # K1 hash-only at 2^21 lanes, both modes of the TPU kernel
    ctx, counters = planted_contexts(ix["keys"], LANES, 1 << 16, device)
    for with_ctx in (True, False):
        got = kernels.callstep_hash(ctx, K, REF_K, with_ctx)
        want = kernels.callstep_hash_plain(ctx, K, REF_K, with_ctx)
        max_abs_err(got, want)
    n_set = bloom_hits(got[0], got[1], ix["bf_packed"][:, 0])
    log(f"K1 hash-only == plain (with_ctx False and True); {n_set} lanes hit the Bloom filter")
    # the random reads alone: torch's gather of the rows the lanes read
    rows = xxh3_mod_size(got[0], got[1], SIZE_BITS)[0]
    gather_ms = cuda_ms(lambda: ix["bf_packed"].index_select(0, rows), iters=20)
    del got, want, rows

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
    n_bf, n_map = int((st_k[:ix["n_counts"]] != 0).sum()), int((kv != 0).sum())
    log(f"K1 fused == plain: {n_bf} counters and {n_map} map values updated")
    if not (st_k[: ix["n_counts"]] != 0).any() or not (kv != 0).any():
        raise AssertionError("K1 check touched no counter or no map value")
    scratch = torch.zeros_like(st_k)
    ms = cuda_ms(lambda: kernels.callstep(ix["bf_packed"], ix["ctx_words"], ix["kmap_keys"],
                                          scratch, ctx, counters, **args), iters=20)
    plain_ms = cuda_ms(lambda: kernels.callstep_plain(ix["bf_packed"], ix["ctx_words"],
                                                      ix["kmap_keys"], scratch, ctx, counters,
                                                      **args), iters=3, warmup=1)
    hash_ms = cuda_ms(lambda: kernels.callstep_hash(ctx, K, REF_K, False), iters=20)
    # per lane: its packed context (12 B) and counter (4 B), its Bloom row
    # (word and rank, 8 B) and context word (4 B); 8 B read and written per
    # counter and map value updated.  Per lane the centre's canonical form,
    # ASCII and hash, and 23 for the Bloom index, bit test, mini-filter,
    # bucket pair and rank; per lane whose Bloom bit is set the context's
    # ASCII, hash and filter test.
    b_ms, b_by = bound(LANES * 28 + (n_bf + n_map) * 8,
                       LANES * (canonical_packed_ops(K) + ascii_ops(K) + xxh3_ops(K) + 23)
                       + n_set * (ascii_ops(REF_K) + xxh3_ops(REF_K) + 5), peak)
    log(f"K1 fused {ms:.4f} ms (bound {b_ms:.4f} ms, {b_by}; {b_ms / ms:.1%} of the bound), "
        f"plain {plain_ms:.4f} ms, hash-only {hash_ms:.4f} ms (with the wrapper's int64 "
        f"planes), torch's gather of the same rows {gather_ms:.4f} ms per {LANES} lanes")
    results.append({"name": "callstep", "route": "cuda",
                    "source": "malva_tpu_torch/csrc/callstep.cu",
                    "replaces": "malva_tpu/ops/pallas_kernels.py:125",
                    "max_abs_err": err1, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None, "lanes": LANES,
                    "bloom_hits": n_set, "hash_only_ms": hash_ms, "gather_ms": gather_ms})
    del st_k, st_p, scratch, ctx, counters

    # K2 on a 2^20-position chunk with N, lowercase and IUPAC bytes, then
    # on one shaped like the run's reference chunks
    bf_words = ix["bf_packed"][:, 0].contiguous()
    k2 = ref_scan_check(reference_chunk(device), bf_words, peak)
    k2["main_path_chunk"] = ref_scan_check(main_path_chunk(device), bf_words, peak)
    results.append({"name": "ref_scan", "route": "cuda",
                    "source": "malva_tpu_torch/csrc/ref_scan.cu",
                    "replaces": "malva_tpu/ops/pallas_kernels.py:222", "library_ms": None, **k2})
    del bf_words
    k4 = shard_update_check(ix, device, peak)
    k5 = gather_update_check(ix, device, peak)
    route = route_check(ix, device, peak, parent)
    scan = scan_check(ix, device, peak, parent)
    scan[0]["scan_alone"] = scan_alone(ix)
    results[0]["event_probe"] = event_timing_probe(ix, device)
    del ix
    results += [seq_count_check(device, peak), k4, k5, *route, *scan]
    return results


def ref_scan_check(seq, bf_words, peak: float) -> dict:
    """K2 on one CHUNK-position chunk against its plain version, both
    modes (the scan into a zeroed context filter, and hash-only), timed
    beside its bound."""
    import torch

    from malva_tpu_torch.ops import kernels
    from malva_tpu_torch.ops.packed import popcount32
    from malva_tpu_torch.ops.xxh3 import xxh3_mod_size

    c_hi, c_lo, *rest = kernels.window_hash(seq, CHUNK, K, REF_K)
    max_abs_err([c_hi, c_lo, *rest], kernels.window_hash_plain(seq, CHUNK, K, REF_K))
    n_hit = bloom_hits(c_hi, c_lo, bf_words)
    # the random reads alone: torch's gather of the words the positions read
    words = xxh3_mod_size(c_hi, c_lo, SIZE_BITS)[0]
    gather_ms = cuda_ms(lambda: bf_words.index_select(0, words), iters=20)
    del c_hi, c_lo, rest, words
    ctx_k = torch.zeros_like(bf_words)
    ctx_p = torch.zeros_like(bf_words)
    kw = dict(k=K, ref_k=REF_K, size_bits=SIZE_BITS)
    kernels.ref_scan(bf_words, ctx_k, seq, CHUNK, **kw)
    kernels.ref_scan_plain(bf_words, ctx_p, seq, CHUNK, **kw)
    torch.cuda.synchronize()
    err = max_abs_err([ctx_k], [ctx_p])
    n_bits = int(popcount32(ctx_k.long() & 0xFFFFFFFF).sum())
    if n_bits == 0:
        raise AssertionError("K2 check set no context bit")
    ms = cuda_ms(lambda: kernels.ref_scan(bf_words, ctx_k, seq, CHUNK, **kw), iters=20)
    hash_ms = cuda_ms(lambda: kernels.window_hash(seq, CHUNK, K, REF_K), iters=20)
    plain_ms = cuda_ms(lambda: kernels.ref_scan_plain(bf_words, ctx_p, seq, CHUNK, **kw),
                       iters=3, warmup=1)
    # per position: its byte, its Bloom word (4 B); 8 B read and written per
    # context bit set.  Per position the centre's canonical form rolled one
    # base on (every window counted as a pure-ACGT one), its ASCII, hash
    # and Bloom test; per hit the window's canonical form from its codes,
    # ASCII, hash and bit set.
    b_ms, b_by = bound(CHUNK + REF_K - 1 + CHUNK * 4 + n_bits * 8,
                       CHUNK * (rolling_ops(K) + ascii_ops(K) + xxh3_ops(K) + 8)
                       + n_hit * (canonical_packed_ops(REF_K) + ascii_ops(REF_K)
                                  + xxh3_ops(REF_K) + 8), peak)
    log(f"K2 scan and hash-only == plain ({n_hit} hits, {n_bits} context bits); scan {ms:.4f} "
        f"ms (bound {b_ms:.4f} ms, {b_by}; {b_ms / ms:.1%} of the bound), hash-only "
        f"{hash_ms:.4f} ms (with the wrapper's int64 planes), torch's gather of the same "
        f"words {gather_ms:.4f} ms, plain {plain_ms:.4f} ms per {CHUNK} positions")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "share_of_bound": b_ms / ms, "hash_only_ms": hash_ms,
            "gather_ms": gather_ms, "positions": CHUNK, "hits": n_hit}


def shard0(ix: dict, device):
    """Shard 0 of the synthetic -b 1 index split SHARDS ways, as
    parallel/sharded_index.py builds a routed shard: its [word, local
    rank] rows with the mini-filter of its own map keys in the rank's top
    bits (and a copy without it), the bucket table of the keys whose Bloom
    word it owns, its counter count, and the mask of those keys."""
    import torch

    from malva_tpu_torch.index.device import (
        RANK_MASK,
        minifilter_rows,
        pack2bit_u32_np,
        pack_bloom_rows,
    )
    from malva_tpu_torch.index.kmap_table import BucketTable
    from malva_tpu_torch.ops.bloom import from_u32
    from malva_tpu_torch.ops.xxh3 import xxh3_64

    wps = SIZE_BITS // 32 // SHARDS
    keys = ix["keys"]
    h = xxh3_64(keys)
    mine = ((h % np.uint64(SIZE_BITS)) >> np.uint64(5)).astype(np.int64) < wps
    table = BucketTable.from_packed(pack2bit_u32_np(keys[mine], K), h[mine], K)
    kmap_keys = from_u32(table.bucket_keys, device)
    mf_rows, mf_bits = (torch.from_numpy(a).to(device) for a in minifilter_rows(h[mine], SIZE_BITS))
    rows = pack_bloom_rows(ix["bf_packed"][:wps, 0].contiguous(), mf_rows, mf_bits)
    rows_off = rows.clone()
    rows_off[:, 1] &= RANK_MASK
    n_counts = int(rows_off[-1, 1]) + bin(int(rows[-1, 0]) & 0xFFFFFFFF).count("1")
    return rows, rows_off, kmap_keys, table, n_counts, mine


def shard_update_check(ix: dict, device, peak: float) -> dict:
    """K4 against its plain version on shard 0 of the synthetic -b 1 index
    split SHARDS ways: the shard's [word, local rank] rows with the
    mini-filter of its own map keys in the rank's top bits (as
    parallel/sharded_index.py builds them), the exact map of the keys whose
    Bloom word it owns, and ROUTED lanes whose Bloom word it owns (the
    routing's guarantee), a quarter of them centred on its map keys, with
    random "context known" flags; then again with rows without the
    mini-filter (every lane probes the map)."""
    import torch

    from malva_tpu_torch.ops import kernels
    from malva_tpu_torch.ops.xxh3 import xxh3_mod_size

    wps = SIZE_BITS // 32 // SHARDS
    rows, rows_off, kmap_keys, table, n_counts, mine = shard0(ix, device)
    keys = ix["keys"]

    ctx, counters = planted_contexts(keys[mine], 4 * ROUTED, ROUTED // 4, device)
    c_hi, c_lo = kernels.callstep_hash_plain(ctx, K, REF_K, with_ctx=False)[:2]
    words = xxh3_mod_size(c_hi, c_lo, SIZE_BITS)[0]
    owned = torch.nonzero(words < wps).squeeze(1)[:ROUTED]
    ctx, counters, words = ctx[owned].contiguous(), counters[owned].contiguous(), words[owned]
    if ctx.shape[0] != ROUTED:
        raise AssertionError(f"K4 check: {ctx.shape[0]} routed lanes, not {ROUTED}")
    # the random reads alone: torch's gather of the rows the lanes read
    gather_ms = cuda_ms(lambda: rows.index_select(0, words), iters=20)
    gen = torch.Generator(device=device).manual_seed(5)
    known = torch.rand(ROUTED, device=device, generator=gen) < 0.5
    n_state = n_counts + table.n_buckets * 4
    out = {}
    for minifilter, r in ((True, rows), (False, rows_off)):
        args = dict(k=K, ref_k=REF_K, size_bits=SIZE_BITS, n_buckets=table.n_buckets,
                    word_base=0, counts_len=n_counts, minifilter=minifilter)
        st_k = torch.zeros(n_state, dtype=torch.int32, device=device)
        st_p = torch.zeros_like(st_k)
        kernels.shard_update(r, kmap_keys, st_k, ctx, counters, known, **args)
        kernels.shard_update_plain(r, kmap_keys, st_p, ctx, counters, known, **args)
        torch.cuda.synchronize()
        out[minifilter] = {"err": max_abs_err([st_k], [st_p]),
                           "n_bf": int((st_k[:n_counts] != 0).sum()),
                           "n_map": int((st_k[n_counts:] != 0).sum())}
        if not out[minifilter]["n_bf"] or not out[minifilter]["n_map"]:
            raise AssertionError("K4 check touched no counter or no map value")
        scratch = torch.zeros_like(st_k)
        out[minifilter]["ms"] = cuda_ms(lambda: kernels.shard_update(
            r, kmap_keys, scratch, ctx, counters, known, **args), iters=20)
        if minifilter:
            plain_ms = cuda_ms(lambda: kernels.shard_update_plain(
                r, kmap_keys, scratch, ctx, counters, known, **args), iters=3, warmup=1)
    if out[True]["n_bf"] != out[False]["n_bf"] or out[True]["n_map"] != out[False]["n_map"]:
        raise AssertionError(f"K4 with and without the mini-filter updated other counters {out}")
    on, ms = out[True], out[True]["ms"]
    cand, reads = bucket_reads(ctx, rows, kmap_keys, table.n_buckets)
    # per lane: context (12 B), counter (4 B), "known" flag (1 B), Bloom row
    # (8 B); 8 B read and written per counter and map value updated; a
    # 32-byte sector per bucket the probe reads (with the mini-filter).
    # The centre's canonical form, ASCII and hash, and 23 as in K1.
    b_ms, b_by = bound(ROUTED * 25 + (on["n_bf"] + on["n_map"]) * 8 + reads * 32,
                       ROUTED * (canonical_packed_ops(K) + ascii_ops(K) + xxh3_ops(K) + 23), peak)
    log(f"K4 == plain on shard 0 of {SHARDS} ({on['n_bf']} counters, {on['n_map']} map values "
        f"updated, {int(mine.sum())} map keys; {cand} probe candidates, {reads} bucket reads), "
        f"with the shard's mini-filter and without it; "
        f"K4 {ms:.4f} ms (bound {b_ms:.4f} ms, {b_by}; {b_ms / ms:.1%} of the bound), without "
        f"the mini-filter {out[False]['ms']:.4f} ms, torch's gather of the same rows "
        f"{gather_ms:.4f} ms, plain {plain_ms:.4f} ms per {ROUTED} routed lanes")
    return {"name": "shard_update", "route": "cuda", "source": "malva_tpu_torch/csrc/shard_step.cu",
            "replaces": "malva_tpu/parallel/sharded_index.py:398 (XLA, no Pallas counterpart)",
            "max_abs_err": max(on["err"], out[False]["err"]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "lanes": ROUTED,
            "gather_ms": gather_ms, "no_minifilter_ms": out[False]["ms"], "candidates": cand,
            "bucket_reads": reads}


def gather_update_check(ix: dict, device, peak: float) -> dict:
    """K5 against its plain version on shard 0 of the synthetic -b 1 index
    cut SHARDS ways as the all-gather design cuts it: the shard's [word,
    local rank] rows without a mini-filter and its contiguous range of the
    one global bucket table, over LANES lanes of a whole gathered batch (a
    quarter centred on map keys, so that a quarter of those have a bucket
    in the range) with random merged "context known" flags."""
    import torch

    from malva_tpu_torch.index.device import pack_bloom_rows
    from malva_tpu_torch.ops import kernels
    from malva_tpu_torch.ops.xxh3 import xxh3_mod_size

    wps, nbps = SIZE_BITS // 32 // SHARDS, ix["n_buckets"] // SHARDS
    none = torch.zeros(0, dtype=torch.int64, device=device)
    rows = pack_bloom_rows(ix["bf_packed"][:wps, 0].contiguous(), none, none)
    kmap_keys = ix["kmap_keys"][:nbps].contiguous()
    n_counts = int(rows[-1, 1]) + bin(int(rows[-1, 0]) & 0xFFFFFFFF).count("1")
    ctx, counters = planted_contexts(ix["keys"], LANES, LANES // 4, device)
    c_hi, c_lo = kernels.callstep_hash_plain(ctx, K, REF_K, with_ctx=False)[:2]
    words = xxh3_mod_size(c_hi, c_lo, SIZE_BITS)[0]
    owned = words[words < wps]
    del c_hi, c_lo, words
    # the random reads alone: torch's gather of the rows the owned lanes read
    gather_ms = cuda_ms(lambda: rows.index_select(0, owned), iters=20)
    gen = torch.Generator(device=device).manual_seed(6)
    known = torch.rand(LANES, device=device, generator=gen) < 0.5
    args = dict(k=K, ref_k=REF_K, size_bits=SIZE_BITS, n_buckets=ix["n_buckets"], word_base=0,
                bucket_base=0, counts_len=n_counts)
    st_k = torch.zeros(n_counts + nbps * 4, dtype=torch.int32, device=device)
    st_p = torch.zeros_like(st_k)
    kernels.gather_update(rows, kmap_keys, st_k, ctx, counters, known, **args)
    kernels.gather_update_plain(rows, kmap_keys, st_p, ctx, counters, known, **args)
    torch.cuda.synchronize()
    err = max_abs_err([st_k], [st_p])
    n_bf, n_map = int((st_k[:n_counts] != 0).sum()), int((st_k[n_counts:] != 0).sum())
    if not n_bf or not n_map:
        raise AssertionError("K5 check touched no counter or no map value")
    scratch = torch.zeros_like(st_k)
    ms = cuda_ms(lambda: kernels.gather_update(rows, kmap_keys, scratch, ctx, counters, known,
                                               **args), iters=20)
    plain_ms = cuda_ms(lambda: kernels.gather_update_plain(rows, kmap_keys, scratch, ctx, counters,
                                                           known, **args), iters=3, warmup=1)
    # per lane: context (12 B), counter (4 B), "known" flag (1 B); per owned
    # lane its Bloom row (8 B); 8 B read and written per counter and map
    # value updated; a 32-byte sector per bucket of the shard's range the
    # probe reads.  Every lane's centre: canonical form, ASCII and hash, and
    # 23 as in K1.
    n_own = int(owned.shape[0])
    cand, reads = bucket_reads(ctx, None, kmap_keys, ix["n_buckets"], n_local=nbps)
    b_ms, b_by = bound(LANES * 17 + n_own * 8 + (n_bf + n_map) * 8 + reads * 32,
                       LANES * (canonical_packed_ops(K) + ascii_ops(K) + xxh3_ops(K) + 23), peak)
    log(f"K5 == plain on shard 0 of {SHARDS} ({n_bf} counters, {n_map} map values updated; "
        f"{n_own} of {LANES} lanes own their Bloom word; {cand} lanes probe the shard's "
        f"buckets, {reads} bucket reads); K5 {ms:.4f} ms (bound {b_ms:.4f} ms, "
        f"{b_by}; {b_ms / ms:.1%} of the bound), torch's gather of the owned lanes' rows "
        f"{gather_ms:.4f} ms, plain {plain_ms:.4f} ms per {LANES} gathered lanes")
    return {"name": "gather_update", "route": "cuda",
            "source": "malva_tpu_torch/csrc/shard_step.cu",
            "replaces": "malva_tpu/parallel/sharded_index.py:141 (XLA, no Pallas counterpart)",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "lanes": LANES, "owned_lanes": n_own,
            "gather_ms": gather_ms, "candidates": cand, "bucket_reads": reads}


def sorted_rows(overflow, tally, wc: int):
    """The rows an overflow list holds, sorted, on its device (the kernels
    append them in the order their atomics land)."""
    import torch

    n = int(tally[0])
    cap = overflow.numel() // (wc + 1)
    rows = torch.cat([overflow[: cap * wc].view(cap, wc)[:n], overflow[cap * wc :][:n, None]], 1)
    for c in reversed(range(wc + 1)):  # lexicographic: stable sorts from the last column
        rows = rows[torch.sort(rows[:, c], stable=True)[1]]
    return rows


ROUTE_DESTS = (1, 3, 4, 16)
ROUTE_OWNERS = ("spread", "clumped", "one", "none")
ROUTE_LANES = (1, 2049, 1 << 22)  # a lane; a tile (2048 lanes) and a lane; more tiles than fit


def route_owners(gen, n: int, D: int, case: str, device):
    """Owner shard of each of n lanes: spread evenly ("none" too: those
    lanes hold no live row), clumped (runs of 37 of one shard, most lanes
    to shard 0) or all to the last shard."""
    import torch

    if case == "one":
        return torch.full((n,), D - 1, dtype=torch.int64, device=device)
    spread = torch.randint(0, D, (n,), generator=gen, device=device)
    if case != "clumped":
        return spread
    runs = torch.randint(0, D, (-(-n // 37),), generator=gen, device=device)
    runs = runs.repeat_interleave(37)[:n]
    return torch.where(torch.rand(n, generator=gen, device=device) < 0.6, 0, runs)


def route_hash(gen, word, size_bits: int):
    """(hi, lo) int64 XXH3 halves whose Bloom index has word ``word`` and
    a random bit, under either of the index's size rules (ops/xxh3.py
    xxh3_mod_size)."""
    import torch

    bit = torch.randint(0, 32, word.shape, generator=gen, device=word.device)
    if size_bits < 1 << 33:
        return torch.randint(0, 1 << 32, word.shape, generator=gen, device=word.device), \
            word << 5 | bit
    return (word >> 28) << 1 | (word >> 27) & 1, (word & ((1 << 27) - 1)) << 5 | bit


def route_case(kind: str, D: int, case: str, n: int, gen, device) -> tuple[int, int, int]:
    """K6 (kind "pack", n source lanes) or K7 ("probe", D received blocks
    of max(1, n // D) rows) on one case, launched twice on one scratch
    into fresh buffers, beside its plain version: the slot blocks, their
    headers and the tallies bit-identical, the overflow lists equal as
    sorted rows, and the scratch zeroed again after each launch.  Returns
    (lanes, rows sent, rows spilled)."""
    import torch

    from malva_tpu_torch.ops import kernels
    from malva_tpu_torch.ops.bloom import storage
    from malva_tpu_torch.ops.kernels import HOP1_COLS, HOP2_COLS, slot_words
    from malva_tpu_torch.parallel.sharded_index import capacity

    wc = (REF_K + 15) // 16

    def i32(shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, generator=gen,
                             device=device)

    if kind == "pack":
        size_bits = 3 << 33 if D == 3 else SIZE_BITS
        wps = size_bits // 32 // D
        cw = route_owners(gen, n, D, case, device) * wps + torch.randint(
            0, wps, (n,), generator=gen, device=device)
        bw = route_owners(gen, n, D, "spread", device) * wps + torch.randint(
            0, wps, (n,), generator=gen, device=device)
        hx = storage(torch.stack([*route_hash(gen, cw, size_bits),
                                  *route_hash(gen, bw, size_bits)]))
        counters = torch.randint(1, 1 << 31, (n,), dtype=torch.int32, generator=gen, device=device)
        counters[torch.rand(n, generator=gen, device=device) < 0.1] = 0
        if case == "none":
            counters.zero_()
        inputs, lanes, cap, cols = (hx, i32((n, wc)), counters), n, capacity(n, D), HOP1_COLS
        kw = dict(size_bits=size_bits, wps=wps, cap=cap)
        fns = (kernels.route_pack, kernels.route_pack_plain)
    else:
        cap_in = max(1, n // D)
        w1 = slot_words(cap_in, wc, HOP1_COLS)
        received = torch.zeros(D, w1, dtype=torch.int32, device=device)
        fill = torch.randint(0, cap_in + 1, (D,), generator=gen, device=device)
        fill[torch.rand(D, generator=gen, device=device) < 0.4] = cap_in
        received[:, 0] = 0 if case == "none" else fill.to(torch.int32)
        received[:, 4 : 4 + cap_in * (wc + 1)] = i32((D, cap_in * (wc + 1)))
        planes = received[:, 4 + cap_in * (wc + 1) :].view(D, 3, cap_in)
        planes[:, 0] = torch.randint(0, 1 << 20, (D, cap_in), generator=gen, device=device)
        planes[:, 1] = torch.randint(0, 32, (D, cap_in), generator=gen, device=device)
        planes[:, 2] = route_owners(gen, D * cap_in, D, case, device).view(D, cap_in)
        inputs = (received.view(-1), i32((1 << 20,)))
        lanes, cap, cols = D * cap_in, capacity(cap_in, D), HOP2_COLS
        kw = dict(wc=wc, cap_in=cap_in, cap=cap)
        fns = (kernels.route_probe, kernels.route_probe_plain)
    ovf_cap = lanes + 1

    def buffers():
        return ([torch.zeros(slot_words(cap, wc, cols), dtype=torch.int32, device=device)
                 for _ in range(D)],
                torch.zeros(ovf_cap * (wc + 1), dtype=torch.int32, device=device),
                torch.zeros(1 + 2 * D, dtype=torch.int64, device=device))

    want = buffers()
    fns[1](*inputs, *want, **kw)
    scratch = kernels.route_scratch(device, D)
    for launch in (1, 2):
        got = buffers()
        fns[0](*inputs, *got, **kw, scratch=scratch)
        torch.cuda.synchronize()
        where = f"{kind} D={D} {case} {lanes} lanes, launch {launch}"
        try:
            max_abs_err(got[0] + [got[2]], want[0] + [want[2]])
        except AssertionError as e:
            raise AssertionError(f"route {where}: {e}") from None
        if not torch.equal(sorted_rows(got[1], got[2], wc), sorted_rows(want[1], want[2], wc)):
            raise AssertionError(f"route {where}: the overflow list differs from the plain one")
        if scratch.any():
            raise AssertionError(f"route {where}: the scratch was not left zeroed")
    t = want[2].to("cpu")
    sent = int(t[1 : 1 + 2 * D].sum())
    if case == "none" and sent:
        raise AssertionError(f"route {kind} D={D}: rows sent with no live lane")
    return lanes, sent, int(t[0])


def route_cases(device) -> int:
    """K6 and K7 against their plain versions at D in ROUTE_DESTS, owners
    in ROUTE_OWNERS, over ROUTE_LANES lanes (the largest launch has 2048
    tiles, more than the card holds at once, so tiles wait on tiles that
    started before them); each case launched twice on one scratch."""
    import torch

    gen = torch.Generator(device=device).manual_seed(10)
    t0 = time.perf_counter()
    n_cases = spilled = 0
    for D in ROUTE_DESTS:
        for case in ROUTE_OWNERS:
            for n in ROUTE_LANES:
                for kind in ("pack", "probe"):
                    spilled += route_case(kind, D, case, n, gen, device)[2]
                    n_cases += 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"K6/K7 == plain in {n_cases} cases (D {ROUTE_DESTS}, owners {ROUTE_OWNERS}, lanes "
        f"{ROUTE_LANES}: up to {ROUTE_LANES[-1] // 2048} tiles of 2048 on {sms} SMs), each "
        f"launched twice on one scratch, left zeroed; {spilled} rows spilled "
        f"({time.perf_counter() - t0:.6g} s)")
    if not spilled:
        raise AssertionError("route cases: no row spilled to an overflow list")
    return n_cases


def bucket_reads(ctx, bf_rows, kmap_keys, n_buckets: int, n_local: int | None = None):
    """(candidates, bucket reads) of the exact-map probe in K4's and K5's
    tails over lanes of packed contexts ``ctx`` (lanes.cuh probe_buckets:
    bucket b1, then b2 unless the key lies in b1).  K4 (``n_local`` None):
    a candidate is a lane whose Bloom word lies in ``bf_rows`` (the shard's
    [word, rank | mini-filter << 28] rows from word 0) with its mini-filter
    bit set.  K5: a lane with a bucket in the shard's first ``n_local``
    buckets, and a bucket past them is not read."""
    import torch

    from malva_tpu_torch.index.device import RANK_BITS
    from malva_tpu_torch.index.kmap_table import bucket_pair, probe_bucket_table
    from malva_tpu_torch.ops.bloom import lanes
    from malva_tpu_torch.ops.packed import canonical_center, decode_byte_cols
    from malva_tpu_torch.ops.xxh3 import xxh3_64_cols, xxh3_mod_size

    can = canonical_center([lanes(ctx[:, j]) for j in range(ctx.shape[1])], K, REF_K)
    c_hi, c_lo = xxh3_64_cols(decode_byte_cols(can, K))
    b1, b2 = bucket_pair(c_hi, c_lo, n_buckets)
    slot, found = probe_bucket_table(kmap_keys, n_buckets, (K + 15) // 16, can, c_hi, c_lo)
    if n_local is None:
        bw = xxh3_mod_size(c_hi, c_lo, SIZE_BITS)[0]
        own = bw < bf_rows.shape[0]
        aux = lanes(bf_rows[torch.where(own, bw, 0), 1])
        cand = own & (((aux >> RANK_BITS) >> ((c_hi >> 28) & 3)) & 1).bool()
        in1 = in2 = torch.ones_like(cand)
    else:
        in1, in2 = b1 < n_local, b2 < n_local
        cand = in1 | in2
    in_b1 = found & (slot // 4 == b1)
    return int(cand.sum()), int((cand & in1).sum() + (cand & in2 & ~in_b1).sum())


def hop_buffers(D: int, w: int, ovf_rows: int, device):
    """Zeroed buffers of a hop on D virtual shards: each shard's received
    blocks (D of w words), the blocks by source (views of them), overflow
    lists of ovf_rows rows and tallies."""
    import torch

    wc = (REF_K + 15) // 16
    recv = [torch.zeros(D * w, dtype=torch.int32, device=device) for _ in range(D)]
    out = [[recv[d][s * w : (s + 1) * w] for d in range(D)] for s in range(D)]
    ovf = [torch.zeros(ovf_rows * (wc + 1), dtype=torch.int32, device=device) for _ in range(D)]
    tally = [torch.zeros(1 + 2 * D, dtype=torch.int64, device=device) for _ in range(D)]
    return recv, out, ovf, tally


def route_hops(slices, hx, ix, fns, D: int, wps: int, cap: int, device):
    """The routed step's two partitions on D virtual shards: K6 (fns[0])
    on each source slice, K7 (fns[1]) on each owner over the hop-1 blocks
    written for it; each hop's ``hop_buffers``."""
    import torch

    from malva_tpu_torch.ops.kernels import HOP1_COLS, HOP2_COLS, slot_words

    wc, n = (REF_K + 15) // 16, slices[0][0].shape[0]
    one = hop_buffers(D, slot_words(cap, wc, HOP1_COLS), n, device)
    two = hop_buffers(D, slot_words(cap, wc, HOP2_COLS), n, device)
    for s, (c, cnt) in enumerate(slices):
        fns[0](hx[s], c, cnt, one[1][s], one[2][s], one[3][s], size_bits=SIZE_BITS, wps=wps,
               cap=cap)
    for d in range(D):
        fns[1](one[0][d], ix["ctx_words"][d * wps : (d + 1) * wps], two[1][d], two[2][d],
               two[3][d], wc=wc, cap_in=cap, cap=cap)
    torch.cuda.synchronize()
    return one, two


def route_check(ix: dict, device, peak: float, parent=None) -> list[dict]:
    """The routed step's partitions on SHARDS virtual shards of the card,
    over LANES lanes of the synthetic -b 1 index (a quarter centred on
    shard 0's map keys), cut into SHARDS source slices: K6 (route_pack) on
    each slice, K7 (route_probe) on each owner, then K4's slot entry on
    shard 0 over the hop-2 blocks the owners wrote for it.  Each kernel
    writes into zeroed buffers beside its plain version on the same
    inputs; the slot blocks, their headers, the tallies and the overflow
    lists (sorted) must be bit-identical, and K4's state too.  The slot
    entry again on the hop-2 blocks of a mix like the run's (2^16 of the
    LANES lanes centred on map keys, as K1's check: a few percent of
    tails), through the kernels' hops.  Timed with CUDA events: K6 on
    source 0, K7 and K4's slot entry on shard 0, each slot mix beside
    torch's gather of its live rows' Bloom rows; with a parent checkout's
    library, the four kernels of both in turns (``parent_ab``)."""
    import torch

    from malva_tpu_torch.ops import kernels
    from malva_tpu_torch.ops.kernels import HOP1_COLS, HOP2_COLS, SLOT_HEAD, slot_words
    from malva_tpu_torch.ops.xxh3 import xxh3_mod_size
    from malva_tpu_torch.parallel.sharded_index import capacity

    D, wc = SHARDS, (REF_K + 15) // 16
    wps = SIZE_BITS // 32 // D
    rows, _, kmap_keys, table, n_counts, mine = shard0(ix, device)
    n = LANES // D
    cap = capacity(n, D)
    w1, w2 = slot_words(cap, wc, HOP1_COLS), slot_words(cap, wc, HOP2_COLS)

    def mix(n_plant: int):
        ctx, counters = planted_contexts(ix["keys"][mine], LANES, n_plant, device)
        perm = torch.randperm(LANES, device=device, generator=torch.Generator(device=device)
                              .manual_seed(7))
        ctx, counters = ctx[perm].contiguous(), counters[perm].contiguous()
        slices = [(ctx[s * n : (s + 1) * n], counters[s * n : (s + 1) * n]) for s in range(D)]
        return slices, [kernels.callstep_hash_words(c, K, REF_K, True) for c, _ in slices]

    slices, hx = mix(LANES // 4)
    got = dict(zip(("one", "two"), route_hops(slices, hx, ix, (kernels.route_pack,
                                                               kernels.route_probe), D, wps, cap,
                                              device)))
    want = dict(zip(("one", "two"), route_hops(slices, hx, ix, (kernels.route_pack_plain,
                                                                kernels.route_probe_plain), D,
                                               wps, cap, device)))
    errs = []
    for hop in ("one", "two"):
        g, w = got[hop], want[hop]
        errs.append(max_abs_err(g[0] + g[3], w[0] + w[3]))
        for d in range(D):
            a, b = sorted_rows(g[2][d], g[3][d], wc), sorted_rows(w[2][d], w[3][d], wc)
            if not torch.equal(a, b):
                raise AssertionError(f"route {hop}: overflow list {d} differs from the plain one")
    t1 = [t.to("cpu") for t in got["one"][3]]
    t2 = [t.to("cpu") for t in got["two"][3]]
    hop1_live = int(sum(t[1 + 0] for t in t1))   # rows shard 0 receives in hop 1
    sent1 = int(t1[0][1 : 1 + D].sum())           # rows source 0 sent
    hop2_live = int(sum(t[1 + D + 0] for t in t2))
    spilled = int(sum(t[0] for t in t1 + t2))
    log(f"K6/K7 == plain on {D} virtual shards ({LANES} lanes, {n} a source, cap {cap}): "
        f"source 0 sent {sent1} rows in hop 1, shard 0 received {hop1_live}, and {hop2_live} "
        f"in hop 2; {spilled} rows spilled to the overflow lists")

    # K4's slot entry on shard 0 over the hop-2 blocks written for it: the
    # planted mix above, and a mix like the run's through the kernels' hops
    args = dict(n_blocks=D, cap=cap, k=K, ref_k=REF_K, size_bits=SIZE_BITS,
                n_buckets=table.n_buckets, word_base=0, counts_len=n_counts, minifilter=True)
    run_slices, run_hx = mix(LANES // 32)  # 2^16 of 2^21, as K1's check
    run_two = route_hops(run_slices, run_hx, ix, (kernels.route_pack, kernels.route_probe), D,
                         wps, cap, device)[1]
    del run_slices, run_hx
    state = torch.zeros(n_counts + table.n_buckets * 4, dtype=torch.int32, device=device)
    mixes, err4 = {}, 0
    for label, slots in (("planted", got["two"][0][0]), ("run_like", run_two[0][0])):
        st_k, st_p = torch.zeros_like(state), torch.zeros_like(state)
        kernels.shard_update_slots(rows, kmap_keys, st_k, slots, **args)
        kernels.shard_update_slots_plain(rows, kmap_keys, st_p, slots, **args)
        torch.cuda.synchronize()
        err4 = max(err4, max_abs_err([st_k], [st_p]))
        n_bf, n_map = int((st_k[:n_counts] != 0).sum()), int((st_k[n_counts:] != 0).sum())
        if not n_bf or not n_map:
            raise AssertionError(f"K4 slot check ({label}) touched no counter or no map value")
        ms = cuda_ms(lambda: kernels.shard_update_slots(rows, kmap_keys, state, slots, **args),
                     iters=20)
        # the random reads alone: torch's gather of the Bloom rows the slot
        # entry reads, those of its live rows' centres
        live = torch.cat([kernels.slot_rows(b, cap, wc, HOP2_COLS) for b in slots.view(D, w2)])
        c_hi, c_lo = kernels.callstep_hash(live[:, :wc].contiguous(), K, REF_K, False)[:2]
        read = xxh3_mod_size(c_hi, c_lo, SIZE_BITS)[0]
        if int((read >= wps).sum()):
            raise AssertionError("K4 slot check: a hop-2 row of shard 0 has another shard's word")
        gather = cuda_ms(lambda: rows.index_select(0, read), iters=20)
        cand, reads = bucket_reads(live[:, :wc].contiguous(), rows, kmap_keys, table.n_buckets)
        n_live = int(live.shape[0])
        # per live row: context, counter, known (20 B) and the Bloom row
        # (8 B); 8 B read and written per counter and map value updated; a
        # 32-byte sector per bucket the probe reads; K4's per-lane hashing
        b4 = bound(n_live * 28 + (n_bf + n_map) * 8 + reads * 32,
                   n_live * (canonical_packed_ops(K) + ascii_ops(K) + xxh3_ops(K) + 23), peak)
        plain = (cuda_ms(lambda: kernels.shard_update_slots_plain(rows, kmap_keys, state, slots,
                                                                  **args), iters=3, warmup=1)
                 if label == "planted" else None)
        mixes[label] = {"ms": ms, "plain_ms": plain, "bound_ms": b4[0], "bound_by": b4[1],
                        "share_of_bound": b4[0] / ms, "rows_live": n_live, "candidates": cand,
                        "bucket_reads": reads, "gather_ms": gather, "over_gather": ms / gather}
        log(f"K4 slots == plain, {label} mix: {n_live} live rows of {D * cap}, {cand} probe "
            f"candidates, {reads} bucket reads; {ms:.4f} ms (bound {b4[0]:.4f} ms, {b4[1]}; "
            f"{b4[0] / ms:.1%} of the bound), torch's gather of the same Bloom rows "
            f"{gather:.4f} ms ({ms / gather:.3f}x)")
        del live, c_hi, c_lo, read, st_k, st_p

    # K6 and K7 timed into fresh buffers (the tallies and lists only grow),
    # each on a scratch of its own
    fresh1, fresh2 = hop_buffers(D, w1, n, device), hop_buffers(D, w2, n, device)
    c0, n0 = slices[0]
    cw0 = ix["ctx_words"][:wps]
    a6 = (hx[0], c0, n0, fresh1[1][0], fresh1[2][0], fresh1[3][0])
    a7 = (got["one"][0][0], cw0, fresh2[1][0], fresh2[2][0], fresh2[3][0])
    k6 = dict(size_bits=SIZE_BITS, wps=wps, cap=cap)
    k7 = dict(wc=wc, cap_in=cap, cap=cap)
    sc6, sc7 = kernels.route_scratch(device, D), kernels.route_scratch(device, D)
    ms6 = cuda_ms(lambda: kernels.route_pack(*a6, **k6, scratch=sc6), iters=20)
    plain6 = cuda_ms(lambda: kernels.route_pack_plain(*a6, **k6), iters=3, warmup=1)
    ms7 = cuda_ms(lambda: kernels.route_probe(*a7, **k7, scratch=sc7), iters=20)
    # K7 again with its context-filter reads inside 1 MiB (L2 hits): what
    # its random reads from device memory cost
    near = a7[0].clone()
    lcw = near.view(D, w1)[:, SLOT_HEAD + cap * (wc + 1) :][:, :cap]
    lcw &= (1 << 18) - 1
    ms7_near = cuda_ms(lambda: kernels.route_probe(near, *a7[1:], **k7, scratch=sc7), iters=20)
    plain7 = cuda_ms(lambda: kernels.route_probe_plain(*a7, **k7), iters=3, warmup=1)
    # the slot entry over D empty blocks: what a launch costs with no row
    empty = torch.zeros_like(run_two[0][0])
    empty_ms = cuda_ms(lambda: kernels.shard_update_slots(rows, kmap_keys, state, empty, **args),
                       iters=20)
    log(f"K4 slots over {D} empty blocks (a launch with no row): {empty_ms:.4f} ms")
    ab = None
    if parent is not None:
        slots = {"planted": got["two"][0][0], "run_like": run_two[0][0], "empty": empty}
        ab = parent_ab(parent, route_turns(a6, k6, a7, k7, slots, rows, kmap_keys, state, args,
                                           device))
    # K6 per lane: its four hash words, context (12 B) and counter (4 B);
    # per row sent, the row (28 B).  K7 per live row received: the row
    # (28 B), its context word (4 B), the hop-2 row written (20 B).
    b6 = bound(n * 32 + sent1 * 28, 0, peak)
    b7 = bound(hop1_live * (28 + 4 + 20), 0, peak)
    for name, ms, b in (("K6", ms6, b6), ("K7", ms7, b7)):
        log(f"{name} {ms:.4f} ms (bound {b[0]:.4f} ms, {b[1]}; {b[0] / ms:.1%} of the bound)")
    log(f"plain versions: K6 {plain6:.4f} ms, K7 {plain7:.4f} ms, K4 slots "
        f"{mixes['planted']['plain_ms']:.4f} ms; K7 with its context-filter reads inside 1 MiB "
        f"{ms7_near:.4f} ms")
    n_cases = route_cases(device)
    src = "malva_tpu_torch/csrc/route.cu"
    common = {"route": "cuda", "library_ms": None, "cap": cap, "shards": D}
    planted = mixes["planted"]
    return [
        {"name": "route_pack", "source": src,
         "replaces": "malva_tpu/parallel/sharded_index.py:330 (pack_dests, XLA, no Pallas "
                     "counterpart)", "max_abs_err": errs[0], "ms": ms6, "plain_ms": plain6,
         "bound_ms": b6[0], "bound_by": b6[1], "lanes": n, "rows_sent": sent1,
         "cases": n_cases // 2, "parent_ab_ms": ab and ab["route_pack"], **common},
        {"name": "route_probe", "source": src,
         "replaces": "malva_tpu/parallel/sharded_index.py:383 (XLA, no Pallas counterpart)",
         "max_abs_err": errs[1], "ms": ms7, "plain_ms": plain7, "bound_ms": b7[0],
         "bound_by": b7[1], "lanes": D * cap, "rows_live": hop1_live, "cases": n_cases // 2,
         "near_reads_ms": ms7_near,
         "parent_ab_ms": ab and ab["route_probe"], **common},
        {"name": "shard_update_slots", "source": "malva_tpu_torch/csrc/shard_step.cu",
         "replaces": "malva_tpu/parallel/sharded_index.py:398 (XLA, no Pallas counterpart; "
                     "K4's slot entry)", "max_abs_err": err4, "ms": planted["ms"],
         "plain_ms": planted["plain_ms"], "bound_ms": planted["bound_ms"],
         "bound_by": planted["bound_by"], "lanes": D * cap, "rows_live": planted["rows_live"],
         "gather_ms": planted["gather_ms"], "mixes": mixes, "empty_blocks_ms": empty_ms,
         "parent_ab_ms": ab and {m: ab[f"shard_update_slots {m}"] for m in (*mixes, "empty")},
         **common}]


def route_turns(a6, k6, a7, k7, slots: dict, rows, kmap_keys, state, args, device) -> dict:
    """K6, K7 and K4's slot entry (at each mix of ``slots``) through their C
    entry points, for ``parent_ab``: {name: fn(lib, scratch)}; the same
    inputs and buffers for both libraries, whose signatures these kernels
    keep."""
    import torch

    from malva_tpu_torch.ops import kernels

    stream = torch.cuda.current_stream().cuda_stream
    hx, ctx, cnt, blocks6, ovf6, tally6 = a6
    recv, cw, blocks7, ovf7, tally7 = a7
    D = len(blocks6)
    ptr6, ptr7 = kernels._pointers(blocks6), kernels._pointers(blocks7)
    wc = ctx.shape[1]

    def pack(lib, scratch):
        return lib.malva_route_pack(hx.data_ptr(), ctx.data_ptr(), cnt.data_ptr(), ctx.shape[0],
                                    wc, k6["size_bits"], k6["wps"], D, ptr6, k6["cap"],
                                    ovf6.data_ptr(), ovf6.numel() // (wc + 1), tally6.data_ptr(),
                                    scratch.data_ptr(), stream)

    def probe(lib, scratch):
        return lib.malva_route_probe(recv.data_ptr(), k7["cap_in"], wc, cw.data_ptr(), D, ptr7,
                                     k7["cap"], ovf7.data_ptr(), ovf7.numel() // (wc + 1),
                                     tally7.data_ptr(), scratch.data_ptr(), stream)

    def slot_entry(blocks):
        def fn(lib, scratch):
            return lib.malva_shard_update_slots(
                blocks.data_ptr(), args["n_blocks"], args["cap"], wc, K, REF_K, rows.data_ptr(),
                0, rows.shape[0], kmap_keys.data_ptr(), state.data_ptr(), args["counts_len"],
                args["n_buckets"], SIZE_BITS, 1, None, None, stream)
        return fn

    return {"route_pack": pack, "route_probe": probe,
            **{f"shard_update_slots {m}": slot_entry(b) for m, b in slots.items()}}


def parent_ab(parent, fns: dict) -> dict:
    """Each kernel of ``fns`` ({name: fn(lib, scratch) -> CUDA error}) of
    this checkout's library and of ``parent`` (another checkout's,
    ``--parent``), on the same inputs and buffers, each library on a
    scratch of its own, in turns: parent, this, this, parent, twice.
    {name: {"parent": [ms, ...], "change": [...]}}."""
    import ctypes

    import torch

    from malva_tpu_torch.ops import _build

    lib = _build.library()
    for name in ("malva_route_pack", "malva_route_probe", "malva_shard_update_slots",
                 "malva_scan_set"):
        getattr(parent, name).argtypes = getattr(lib, name).argtypes
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # a K8 of two launches (an earlier version) takes a buffer of codes, int64 a position
    parent.malva_scan_pack.argtypes = ([p, i64, i, i, p, i64, p, i64, i, i, p, i64, p, i64, p, p,
                                        p] if k8_takes_codes(parent)
                                       else lib.malva_scan_pack.argtypes)
    parent.malva_route_scratch_words.argtypes = [i]
    parent.malva_route_scratch_words.restype = i64
    scratch = {l: torch.zeros(l.malva_route_scratch_words(16), dtype=torch.int64, device="cuda")
               for l in (lib, parent)}
    out = {}
    for name, fn in fns.items():
        t = out[name] = {"parent": [], "change": []}

        def call(l):
            err = fn(l, scratch[l])
            if err:
                raise RuntimeError(f"{name} ({'parent' if l is parent else 'this'}): CUDA error "
                                   f"{err}")

        for l in (parent, lib, lib, parent) * 2:
            t["parent" if l is parent else "change"].append(cuda_ms(lambda: call(l), iters=20))
        if any(x.any() for x in scratch.values()):
            raise AssertionError(f"{name}: a launch did not leave its scratch zeroed")
        log(f"{name} in turns with the parent's, ms: parent {t['parent']}, this {t['change']}")
    return out


SCAN_ALONE = 1 << 28  # positions of the scan-alone contig
SCAN_DESTS = (1, 3, 4, 16)
SCAN_OWNERS = ("spread", "clumped", "one", "none")
# positions of a case: its slot rows (None: a third of a uniform share, so that rows spill)
SCAN_CASE_POSITIONS = {1: 1, 2049: 2049, 1 << 22: None}
SCAN_ALL_HITS = 1 << 22  # positions of the cases where every position hits


def scan_rows(overflow, n: int, W: int):
    """The first n rows of a scan overflow list ([W planes | owner plane]),
    sorted, on its device (the kernel appends them in the order its
    atomics land)."""
    import torch

    rows = overflow.view(W + 1, -1)[:, :n].t()
    for c in reversed(range(W + 1)):  # lexicographic: stable sorts from the last column
        rows = rows[torch.sort(rows[:, c], stable=True)[1]]
    return rows


def kernel_launches(fn) -> int | None:
    """Kernel launches on the card during fn(), from a torch.profiler
    trace (its "kernel" events); None where the trace holds no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return len(kernels) if kernels else None


def scan_case(D: int, case: str, n: int, gen, device) -> tuple[int, int]:
    """K8 (``scan_pack``, one launch) on one case, launched twice on one
    scratch into fresh buffers, beside ``scan_pack_plain``: n positions of
    random ACGT with an N run, whose hits go to owners as ``case`` says,
    made through the alt words: each position's centre and context Bloom
    indices (K2's hash-only mode), and alt words holding the centre bits of
    the positions chosen to hit: a random four fifths ("spread"), most of
    owner 0's and a tenth of the rest ("clumped"), all of the last owner's
    ("one"), none, or every bit set ("all": every tile all hits).  Slot
    blocks, headers and tallies bit-identical, the overflow lists equal as
    sorted rows, the scratch left zeroed.  Rows of one word at D = 3, 4 and
    16 (2^33 bits, 3 x 2^33 at D = 3), of two at D = 1.  Returns (rows
    spilled, hits)."""
    import torch

    from malva_tpu_torch.ops import kernels
    from malva_tpu_torch.ops.bloom import bloom_set
    from malva_tpu_torch.ops.xxh3 import xxh3_mod_size

    size_bits = 3 * SIZE_BITS if D == 3 else SIZE_BITS
    wps = size_bits // 32 // D
    W = kernels.scan_row_words(wps)
    acgt = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=device)
    seq = acgt[torch.randint(0, 4, (n + REF_K - 1,), generator=gen, device=device)]
    seq[n // 3 : n // 3 + REF_K + 7] = ord("N")
    c_hi, c_lo, x_hi, x_lo = kernels.window_hash(seq, n, K, REF_K)
    cw, cb = xxh3_mod_size(c_hi, c_lo, size_bits)
    owner = xxh3_mod_size(x_hi, x_lo, size_bits)[0] // wps
    r = torch.rand(n, generator=gen, device=device)
    bf = torch.full((size_bits // 32,), -1 if case == "all" else 0, dtype=torch.int32,
                    device=device)
    if case in ("spread", "clumped", "one"):
        hit = {"spread": r < 0.8, "clumped": torch.where(owner == 0, r < 0.95, r < 0.1),
               "one": owner == D - 1}[case]
        bloom_set(bf, cw, cb, hit)
    del c_hi, c_lo, x_hi, x_lo, cw, cb, owner, r
    cap = SCAN_CASE_POSITIONS[n] or max(1, n // (3 * D))
    ovf_cap = n + 1
    kw = dict(k=K, ref_k=REF_K, size_bits=size_bits, wps=wps, cap=cap)

    def buffers():
        return ([torch.zeros(kernels.scan_slot_words(cap, W), dtype=torch.int32, device=device)
                 for _ in range(D)],
                torch.zeros(ovf_cap * (W + 1), dtype=torch.int32, device=device),
                torch.zeros(1 + D, dtype=torch.int64, device=device))

    want = buffers()
    kernels.scan_pack_plain(seq, n, bf, *want, **kw)
    scratch = kernels.route_scratch(device, D)
    spilled = int(want[2][0])
    for launch in (1, 2):
        got = buffers()
        kernels.scan_pack(seq, n, bf, *got, scratch=scratch, **kw)
        torch.cuda.synchronize()
        where = f"K8 D={D} {case} {n} positions, cap {cap}, launch {launch}"
        try:
            max_abs_err(got[0] + [got[2]], want[0] + [want[2]])
        except AssertionError as e:
            raise AssertionError(f"{where}: {e}") from None
        if not torch.equal(scan_rows(got[1], spilled, W), scan_rows(want[1], spilled, W)):
            raise AssertionError(f"{where}: the overflow list differs from the plain one")
        if scratch.any():
            raise AssertionError(f"{where}: the scratch was not left zeroed")
    hits = int(want[2][1:].sum()) + spilled
    if (case == "none" and hits) or (case == "all" and hits != n):
        raise AssertionError(f"K8 D={D} {case}: {hits} hits of {n} positions")
    return spilled, hits


def scan_cases(device) -> int:
    """K8 against its plain version at D in SCAN_DESTS, owners in
    SCAN_OWNERS, over the positions of SCAN_CASE_POSITIONS, and at each D
    with every position a hit over 2^22 positions (2048 tiles of 2048
    hits, more than the card holds at once, with slots that overflow);
    each case launched twice on one scratch."""
    import torch

    gen = torch.Generator(device=device).manual_seed(11)
    t0 = time.perf_counter()
    n_cases = spilled = hits = 0
    cases = [(D, case, n) for D in SCAN_DESTS for case in SCAN_OWNERS for n in SCAN_CASE_POSITIONS]
    cases += [(D, "all", SCAN_ALL_HITS) for D in SCAN_DESTS]
    for D, case, n in cases:
        got = scan_case(D, case, n, gen, device)
        spilled, hits, n_cases = spilled + got[0], hits + got[1], n_cases + 1
    log(f"K8 == plain in {n_cases} cases (D {SCAN_DESTS}, owners {SCAN_OWNERS} over positions "
        f"{tuple(SCAN_CASE_POSITIONS)}, and every position a hit over 2^22 at each D), each "
        f"launched twice on one scratch, left zeroed; {hits} hits, {spilled} rows spilled "
        f"({time.perf_counter() - t0:.6g} s)")
    if not spilled:
        raise AssertionError("scan cases: no row spilled to an overflow list")
    return n_cases


def main_path_contig(n: int, seed: int) -> np.ndarray:
    """n bytes shaped like the run's reference (uppercase ACGT, runs of N
    and IUPAC codes at 1e-4), from a seed."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, n)]
    for start in rng.integers(0, n, 4):
        seq[start : start + int(rng.integers(n // 4000, n // 200))] = ord("N")
    iupac = rng.random(n) < 1e-4
    seq[iupac] = np.frombuffer(b"RYSWKMBDHV", dtype=np.uint8)[rng.integers(0, 10, int(iupac.sum()))]
    return seq


def scan_check(ix: dict, device, peak: float, parent=None) -> list[dict]:
    """K8 and K9 at the sharded scan's shapes: one chunk of SHARDS x CHUNK
    positions of a contig shaped like the run's reference, on SHARDS
    virtual shards of the card over the synthetic -b 1 index's alt words,
    with the scan's slot capacity (``scan_capacity``): K8 (``scan_pack``)
    on each shard's slice and K9 (``scan_set``) on each owner over the
    blocks written for it, beside their plain versions on the same inputs
    (bit-identical blocks, tallies and context words); K8's launches on
    the card counted from a profiler trace; then the K8 cases
    (``scan_cases``).  Timed with CUDA events: K8 on slice 0, K2's scan on
    the same slice (the scan half of K8's work), K9 on owner 0; with a
    parent checkout's library, its K8 and K9 in turns with this one's."""
    import torch

    from malva_tpu_torch.ops import kernels
    from malva_tpu_torch.parallel.sharded_index import scan_capacity

    D, n = SHARDS, CHUNK
    wps = SIZE_BITS // 32 // D
    W = kernels.scan_row_words(wps)
    cap = scan_capacity(n, D)
    w = kernels.scan_slot_words(cap, W)
    contig = torch.from_numpy(main_path_contig(D * n + REF_K - 1, 9)).to(device)
    slices = [contig[s * n : (s + 1) * n + REF_K - 1] for s in range(D)]
    bf_words = ix["bf_packed"][:, 0].contiguous()
    kw = dict(k=K, ref_k=REF_K, size_bits=SIZE_BITS, wps=wps, cap=cap)

    def buffers():
        recv = [torch.zeros(D * w, dtype=torch.int32, device=device) for _ in range(D)]
        out = [[recv[d][s * w : (s + 1) * w] for d in range(D)] for s in range(D)]
        ovf = [torch.zeros(n * (W + 1), dtype=torch.int32, device=device) for _ in range(D)]
        tally = [torch.zeros(1 + D, dtype=torch.int64, device=device) for _ in range(D)]
        ctx = [torch.zeros(wps, dtype=torch.int32, device=device) for _ in range(D)]
        return recv, out, ovf, tally, ctx

    got, want = buffers(), buffers()
    for s, seq in enumerate(slices):
        kernels.scan_pack(seq, n, bf_words, got[1][s], got[2][s], got[3][s], **kw)
        kernels.scan_pack_plain(seq, n, bf_words, want[1][s], want[2][s], want[3][s], **kw)
    torch.cuda.synchronize()
    err8 = max_abs_err(got[0] + got[3], want[0] + want[3])
    for d in range(D):
        kernels.scan_set(got[4][d], got[0][d], n_blocks=D, cap=cap, W=W)
        kernels.scan_set_plain(want[4][d], want[0][d], n_blocks=D, cap=cap, W=W)
    torch.cuda.synchronize()
    err9 = max_abs_err(got[4], want[4])
    t = [x.to("cpu") for x in got[3]]
    hits0 = int(t[0][1:].sum())                 # rows slice 0 sent
    live0 = int(sum(x[1] for x in t))           # rows owner 0 received
    spilled = int(sum(x[0] for x in t))
    n_set = int(sum((c != 0).sum() for c in got[4]))
    if not live0 or not n_set:
        raise AssertionError("K8/K9 check: no hit reached owner 0, or no context word set")
    if spilled:
        raise AssertionError(f"K8 check: {spilled} rows spilled at the scan's capacity {cap}")
    log(f"K8/K9 == plain on {D} virtual shards ({n} positions a slice, cap {cap}, rows of "
        f"{4 * W} bytes): slice 0 sent {hits0} hits, owner 0 received {live0}; {n_set} context "
        f"words set")

    # timing, into fresh buffers (the tallies only grow)
    tb = buffers()
    sc = kernels.route_scratch(device, D)
    pack0 = (slices[0], n, bf_words, tb[1][0], tb[2][0], tb[3][0])
    launches = kernel_launches(lambda: kernels.scan_pack(*pack0, scratch=sc, **kw))
    if launches not in (None, 1):
        raise AssertionError(f"K8: {launches} kernel launches a slice, not one")
    log(f"K8's kernel launches a slice (profiler trace): "
        f"{'not measured' if launches is None else launches}")
    ms8 = cuda_ms(lambda: kernels.scan_pack(*pack0, scratch=sc, **kw), iters=20)
    plain8 = cuda_ms(lambda: kernels.scan_pack_plain(*pack0, **kw), iters=3, warmup=1)
    # K2's scan on the same slice: the scan half of K8's work
    scan_words = torch.zeros_like(bf_words)
    scan_ms = cuda_ms(lambda: kernels.ref_scan(bf_words, scan_words, slices[0], n, k=K,
                                               ref_k=REF_K, size_bits=SIZE_BITS), iters=20)
    del scan_words
    ms9 = cuda_ms(lambda: kernels.scan_set(tb[4][0], got[0][0], n_blocks=D, cap=cap, W=W),
                  iters=20)
    plain9 = cuda_ms(lambda: kernels.scan_set_plain(tb[4][0], got[0][0], n_blocks=D, cap=cap,
                                                    W=W), iters=3, warmup=1)
    ab = None
    if parent is not None:
        turns = scan_turns(pack0, kw, W, got[0][0], tb[4][0], device)
        ab = parent_ab(parent, turns)
        p_sc = torch.zeros(parent.malva_route_scratch_words(D), dtype=torch.int64, device=device)
        ab["parent_launches"] = kernel_launches(lambda: turns["scan_pack"](parent, p_sc))
        log(f"the parent's K8: {ab['parent_launches']} kernel launches a slice (profiler trace)")
    # K8: the slice's bytes with the halo, one 32-byte sector of alt words a
    # position, the slot rows written and the headers; K2's operations (the
    # centre per position, the window per hit).  K9: the rows read and one
    # 32-byte sector a row ORed, with the headers.
    b8 = bound(n + REF_K - 1 + n * 32 + hits0 * 4 * W + D * 16,
               n * (rolling_ops(K) + ascii_ops(K) + xxh3_ops(K) + 8)
               + hits0 * (canonical_packed_ops(REF_K) + ascii_ops(REF_K) + xxh3_ops(REF_K) + 8),
               peak)
    b9 = bound(live0 * (4 * W + 32) + D * 16, live0 * 6, peak)
    for name, ms, b, plain in (("K8", ms8, b8, plain8), ("K9", ms9, b9, plain9)):
        log(f"{name} {ms:.4f} ms (bound {b[0]:.4f} ms, {b[1]}; {b[0] / ms:.1%} of the bound), "
            f"plain {plain:.4f} ms")
    log(f"K2's scan on K8's slice {scan_ms:.4f} ms: K8's partition costs {ms8 - scan_ms:.4f} ms "
        f"more")
    n_cases = scan_cases(device)
    common = {"route": "cuda", "library_ms": None, "cap": cap, "shards": D, "row_bytes": 4 * W}
    return [
        {"name": "scan_pack", "source": "malva_tpu_torch/csrc/ref_scan.cu",
         "replaces": "malva_tpu/ops/pallas_kernels.py:222 (pallas_call :273), K2's sharded "
                     "entry, with the hits' all-gather of "
                     "malva_tpu/parallel/sharded_index.py:567-569",
         "max_abs_err": err8, "ms": ms8, "plain_ms": plain8, "bound_ms": b8[0],
         "bound_by": b8[1], "positions": n, "hits": hits0, "scan_half_ms": scan_ms,
         "kernel_launches_a_slice": launches, "cases": n_cases,
         "parent_ab_ms": ab and ab["scan_pack"],
         "parent_launches_a_slice": ab and ab["parent_launches"], **common},
        {"name": "scan_set", "source": "malva_tpu_torch/csrc/ref_scan.cu",
         "replaces": "malva_tpu/parallel/sharded_index.py:570-572 (bloom_set on the owner, XLA, "
                     "no Pallas counterpart)",
         "max_abs_err": err9, "ms": ms9, "plain_ms": plain9, "bound_ms": b9[0],
         "bound_by": b9[1], "rows_live": live0, "parent_ab_ms": ab and ab["scan_set"],
         **common}]


def k8_takes_codes(lib) -> bool:
    """Whether a kernel library's K8 is the earlier two launches (K2's
    codes into a buffer it is given, then their partition)."""
    return hasattr(lib, "malva_scan_codes")


def scan_turns(pack0: tuple, kw: dict, W: int, recv, ctx_words, device) -> dict:
    """K8 on ``pack0``'s slice and K9 on owner 0's received blocks through
    their C entry points, for ``parent_ab``; a K8 of two launches gets a
    buffer of codes of its own."""
    import torch

    from malva_tpu_torch.ops import kernels

    seq, n, bf_words, blocks, ovf, tally = pack0
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = kernels._pointers(blocks)
    codes = torch.empty(n, dtype=torch.int64, device=device)
    D, ovf_cap = len(blocks), ovf.numel() // (W + 1)

    def pack(lib, scratch):
        head = (seq.data_ptr(), n, K, REF_K, bf_words.data_ptr(), kw["size_bits"])
        tail = (kw["wps"], W, D, ptrs, kw["cap"], ovf.data_ptr(), ovf_cap, tally.data_ptr(),
                scratch.data_ptr(), stream)
        if k8_takes_codes(lib):
            return lib.malva_scan_pack(*head, codes.data_ptr(), *tail)
        return lib.malva_scan_pack(*head, *tail)

    def scan_set(lib, scratch):
        return lib.malva_scan_set(recv.data_ptr(), D, kw["cap"], W, ctx_words.data_ptr(), stream)

    return {"scan_pack": pack, "scan_set": scan_set}


def scan_alone(ix: dict) -> dict:
    """The context scan alone on a SCAN_ALONE-position contig (random ACGT from a
    numpy seed) over the synthetic -b 1 index's alt words: the one-card
    scan (``build_context_device``, K2) and the sharded scan on SHARDS
    virtual shards of the card (``build_context_sharded``, K8 and K9), in
    turns (one, sharded, sharded, one); the words must be equal.  Walls by
    the host clock (each returns after its read-back), and the sharded
    scan's own line."""
    import types

    import torch

    from malva_tpu_torch.index.device import build_context_device
    from malva_tpu_torch.ops.bloom import to_u32
    from malva_tpu_torch.parallel.sharded_index import build_context_sharded
    from malva_tpu_torch.utils.config import Config

    rng = np.random.default_rng(12)
    contig = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, SCAN_ALONE + REF_K - 1)]
    words = to_u32(ix["bf_packed"][:, 0])
    cfg = Config(k=K, ref_k=REF_K, bf_size=SIZE_BITS)
    mesh = [torch.device("cuda", 0)] * SHARDS
    walls: dict = {"one card": [], "sharded": []}
    got, lines = {}, []
    for kind in ("one card", "sharded", "sharded", "one card"):
        index = types.SimpleNamespace(bf=types.SimpleNamespace(words=words),
                                      context_bf=types.SimpleNamespace(
                                          words=np.zeros_like(words)))
        tee = _Tee(sys.stderr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(tee):
            if kind == "one card":
                build_context_device(index, [contig], cfg, torch.device("cuda", 0))
            else:
                build_context_sharded(index, [contig], cfg, mesh)
        walls[kind].append(time.perf_counter() - t0)
        lines += [ln for ln in tee.buf.getvalue().splitlines() if "sharded context scan:" in ln]
        if kind in got:
            if not np.array_equal(got[kind], index.context_bf.words):
                raise AssertionError(f"scan alone: two {kind} scans differ")
        got[kind] = index.context_bf.words
    if not np.array_equal(got["one card"], got["sharded"]):
        raise AssertionError("scan alone: the sharded scan's words differ from the one-card scan's")
    if not got["one card"].any():
        raise AssertionError("scan alone: no context bit set")
    for line in lines:
        if "host reads 0 in the chunks" not in line:
            raise AssertionError(f"scan alone: host reads in the chunks: {line}")
    log(f"scan alone, {SCAN_ALONE} positions, one card against {SHARDS} virtual shards (s, in "
        f"turns): "
        f"{json.dumps(walls)}; words equal; {lines[-1]}")
    return {"positions": SCAN_ALONE, "walls_s": walls, "sharded_lines": lines}


# Run from a checkout's root with its path: the scan alone as scan_alone
# runs it, on 4 virtual shards (a warm-up, then five timed scans, each
# logging its sharded context scan line); prints the walls as JSON.
SCAN_ALONE_RUN = r"""
import json, sys, time, types
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from malva_tpu_torch.bench import synthetic_index
from malva_tpu_torch.ops.bloom import to_u32
from malva_tpu_torch.parallel.sharded_index import build_context_sharded
from malva_tpu_torch.utils.config import Config
n, ref_k, k, bits, shards = (int(a) for a in sys.argv[2:7])
ix = synthetic_index(torch.device("cuda", 0), bits.bit_length() - 1, 6, 1 << 20)
words = to_u32(ix["bf_packed"][:, 0])
rng = np.random.default_rng(12)
contig = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, n + ref_k - 1)]
cfg = Config(k=k, ref_k=ref_k, bf_size=bits)
walls = []
for _ in range(6):
    index = types.SimpleNamespace(bf=types.SimpleNamespace(words=words),
                                  context_bf=types.SimpleNamespace(words=np.zeros_like(words)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build_context_sharded(index, [contig], cfg, [torch.device("cuda", 0)] * shards)
    walls.append(time.perf_counter() - t0)
print(json.dumps({"walls_s": walls[1:], "bits_set": int(np.unpackbits(
    index.context_bf.words.view(np.uint8)).sum())}))
"""

# Run from a checkout's root with its path and the chr-scale inputs:
# build_index + call on 4 virtual shards of the card, as sharded_legs runs
# them (the sharded call step's line goes to stderr).
SHARDED_RUN = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
from malva_tpu_torch import cli, pipeline
from malva_tpu_torch.parallel.mesh import make_mesh
k, ref_k, shards, fa, vcf, fq, out = sys.argv[2:9]
cfg = cli._config(cli._parser().parse_args(["run", "--backend", "cuda", "-k", k, "-r", ref_k,
                                            "-b", "1", "-f", "AF", fa, vcf, fq]))
mesh = make_mesh(devices=[torch.device("cuda", 0)] * int(shards))
index = pipeline.build_index(cfg, mesh=mesh)
with open(out, "w") as f:
    pipeline.call(cfg, index, f, mesh=mesh)
"""

SCAN_PARTS = re.compile(r"sharded context scan: .*?K8 ([0-9.e+-]+) ms, K9 [0-9.e+-]+ ms .*?"
                        r"chunks ([0-9.e+-]+) s")
STEP_LINE = re.compile(r"sharded call step \(routed\): \d+ distinct k-mers in (\d+) steps over "
                       r"(\d+) shards.*?K4 ([0-9.e+-]+) ms \(launcher events\)")


def checkout_turns(parent: str, script: str, argv: list[str], timeout: int) -> dict:
    """``script`` run in its own process from the parent checkout and from
    this one, in turns (parent, this, this, parent), each from its own
    root with its own kernels (built at its first run):
    {"parent": [(stdout, stderr), ...], "change": [...]}."""
    out: dict = {"parent": [], "change": []}
    for label, root in (("parent", parent), ("change", REPO), ("change", REPO),
                        ("parent", parent)):
        p = subprocess.run([sys.executable, "-c", script, root, *argv], cwd=root,
                           capture_output=True, text=True, timeout=timeout)
        if p.returncode != 0:
            raise RuntimeError(f"{label}'s run failed (rc={p.returncode}):\n{p.stderr[-4000:]}")
        out[label].append((p.stdout, p.stderr))
    return out


def parent_runs(parent: str, src: str, work: str, run_vcf: bytes) -> dict:
    """With a parent checkout: the scan alone on SCAN_ALONE positions over
    SHARDS virtual shards, and the chr-scale sharded run (its VCF equal to
    the host run's), each from both checkouts in turns; the scan's walls
    and K4's slot entry's mean time a launch on the run (its launcher
    events over its launches: steps x shards)."""
    t0 = time.perf_counter()
    scans = checkout_turns(parent, SCAN_ALONE_RUN,
                           [str(SCAN_ALONE), str(REF_K), str(K), str(SIZE_BITS), str(SHARDS)], 900)
    walls = {k: [json.loads(o.strip().splitlines()[-1]) for o, _ in v] for k, v in scans.items()}
    if len({w["bits_set"] for v in walls.values() for w in v}) != 1:
        raise AssertionError(f"scan alone: the checkouts' context words differ: {walls}")
    # each timed scan's chunks (the part the kernels run in) and K8's events
    parts = {k: [[(float(m.group(2)), float(m.group(1))) for m in SCAN_PARTS.finditer(e)][1:]
                 for _, e in v] for k, v in scans.items()}
    log(f"scan alone, {SCAN_ALONE} positions on {SHARDS} virtual shards, parent and this in "
        f"turns (s): {json.dumps({k: [w['walls_s'] for w in v] for k, v in walls.items()})}; "
        f"(chunks s, K8 ms) of each: {json.dumps(parts)}")
    fa, vcf, fq = stage(src, work, {n: n for n in ("synth.fa", "synth.vcf", "synth.fq")})
    out = os.path.join(work, "ab.vcf")
    runs = checkout_turns(parent, SHARDED_RUN, [str(K), str(REF_K), str(SHARDS), fa, vcf, fq, out],
                          900)
    per_launch: dict = {"parent": [], "change": []}
    for label, got in runs.items():
        for _, err in got:
            m = STEP_LINE.search(err)
            if m is None:
                raise AssertionError(f"the {label}'s sharded run logged no routed step line")
            steps, shards, ms = int(m.group(1)), int(m.group(2)), float(m.group(3))
            per_launch[label].append(ms / (steps * shards))
    if open(out, "rb").read() != run_vcf:
        raise AssertionError("the last sharded run's VCF differs from the host run's")
    log(f"K4's slot entry on the chr-scale sharded run, ms a launch (launcher events), parent "
        f"and this in turns: {json.dumps(per_launch)} ({time.perf_counter() - t0:.6g} s)")
    return {"scan_alone_s": {k: [w["walls_s"] for w in v] for k, v in walls.items()},
            "scan_alone_chunks_s_k8_ms": parts, "slot_entry_ms_a_launch": per_launch}


def event_timing_probe(ix: dict, device) -> dict:
    """K1 steps of 2^20 lanes timed by the CUDA events that K1's launcher
    records, with no other Python thread and with two threads spinning on
    the GIL: the busy mean must stay within 2x the quiet mean, since the
    events sit around the launch inside one C call."""
    import threading

    import torch

    from malva_tpu_torch.index.device import events_ms, timing_events
    from malva_tpu_torch.ops import kernels

    ctx, counters = planted_contexts(ix["keys"], 1 << 20, 1 << 15, device)
    state = torch.zeros(ix["n_counts"] + ix["n_buckets"] * 4, dtype=torch.int32, device=device)
    args = dict(k=K, ref_k=REF_K, size_bits=SIZE_BITS, n_buckets=ix["n_buckets"],
                minifilter=True)

    def steps(n: int) -> list[float]:
        out = []
        for _ in range(n):
            ev = timing_events(device)
            kernels.callstep(ix["bf_packed"], ix["ctx_words"], ix["kmap_keys"], state, ctx,
                             counters, events=ev, **args)
            out.append(events_ms([ev]))
        return out

    steps(3)
    quiet = steps(20)
    stop = threading.Event()

    def spin():
        x = 0
        while not stop.is_set():
            x += 1

    spinners = [threading.Thread(target=spin) for _ in range(2)]
    for t in spinners:
        t.start()
    try:
        busy = steps(20)
    finally:
        stop.set()
        for t in spinners:
            t.join()
    q, b = sum(quiet) / len(quiet), sum(busy) / len(busy)
    log(f"K1 launcher events, 2^20 lanes: quiet mean {q:.6g} ms ({min(quiet):.6g}-"
        f"{max(quiet):.6g}), two spinning threads mean {b:.6g} ms ({min(busy):.6g}-"
        f"{max(busy):.6g})")
    if b > 2 * q:
        raise AssertionError(f"event-timed K1 under two busy threads {b} ms > 2x quiet {q} ms")
    return {"quiet_mean_ms": q, "busy_mean_ms": b, "quiet_max_ms": max(quiet),
            "busy_max_ms": max(busy)}


def read_chunk():
    """WINDOWS + REF_K - 1 bytes of reads joined by 0xFF (the counter's
    layout): mostly ACGT, with N and lowercase bases, and reads of 10 to
    300 bases (some shorter than ref_k).  Returns (chunk, reads)."""
    rng = np.random.default_rng(3)
    alpha = np.frombuffer(b"ACGT" * 40 + b"acgtN", dtype=np.uint8)
    chunk = alpha[rng.integers(0, alpha.shape[0], WINDOWS + REF_K - 1)]
    seps = np.cumsum(rng.integers(11, 302, WINDOWS // 100))
    seps = seps[seps < chunk.shape[0] - 1]
    chunk[seps] = 0xFF
    chunk[-1] = 0xFF
    reads = [r for r in chunk.tobytes().split(b"\xff") if r]
    return chunk, reads


def ragged_chunk(rng, n_bytes: int, ref_k: int) -> np.ndarray:
    """n_bytes of reads of ref_k / 2 to 3 ref_k bases joined by 0xFF, with
    N, IUPAC codes and lowercase bases, and palindromic windows (their two
    forms equal) planted where ref_k is even."""
    alpha = np.frombuffer(b"ACGT" * 40 + b"acgtNRY", dtype=np.uint8)
    chunk = alpha[rng.integers(0, alpha.shape[0], n_bytes)]
    seps = np.cumsum(rng.integers(ref_k // 2, 3 * ref_k, n_bytes // (ref_k // 2)))
    chunk[seps[seps < n_bytes]] = 0xFF
    if ref_k % 2 == 0:
        half = rng.integers(0, 4, ref_k // 2)
        pal = np.frombuffer(b"ACGT", dtype=np.uint8)[np.concatenate([half, 3 - half[::-1]])]
        for at in range(5, n_bytes - 2 * ref_k, 997):
            chunk[at : at + ref_k] = pal
    return chunk


def host_sorted_counts(reads: list[bytes]):
    """The host counter's sort-count of every pure-ACGT window of the
    reads: native read_kmers + _sorted_counts, or numpy where the native
    library is missing."""
    from malva_tpu_torch.count.counter import _sorted_counts, _windows_of_read
    from malva_tpu_torch.ops.seq import canonical, pack_2bit
    from malva_tpu_torch.utils import native

    packed = native.read_kmers(reads, REF_K)
    if packed is None:
        packed = pack_2bit(canonical(np.concatenate([_windows_of_read(r, REF_K)
                                                     for r in reads])))
    return _sorted_counts(packed)


def seq_pack_ragged(device) -> int:
    """K3 against its plain version with zero tolerance on a short ragged
    chunk at each ref_k of K3_REF_KS: n_pos not a multiple of the kernel's
    tile, the chunk read from an aligned and from an unaligned address.
    Returns the number of windows checked."""
    import torch

    from malva_tpu_torch.ops import kernels

    n = 0
    for ref_k in K3_REF_KS:
        n_pos = 2 * K3_TILE + 777 + ref_k
        chunk = torch.from_numpy(ragged_chunk(np.random.default_rng(ref_k), n_pos + ref_k,
                                              ref_k)).to(device)
        for seq in (chunk[:-1], chunk[1:]):
            keys, valid = kernels.seq_pack(seq, n_pos, ref_k)
            pk, pv = kernels.seq_pack_plain(seq, n_pos, ref_k)
            torch.cuda.synchronize()
            max_abs_err([keys >> 32, keys & 0xFFFFFFFF, valid], [pk >> 32, pk & 0xFFFFFFFF, pv])
            if not 0 < int(valid.sum()) < n_pos:
                raise AssertionError(f"K3 ragged check at ref_k {ref_k}: {int(valid.sum())} "
                                     f"valid windows of {n_pos}")
            n += n_pos
    return n


def seq_count_check(device, peak: float) -> dict:
    """K3 against its plain version on one counter chunk and on the short
    ragged chunks, and the device sort-count step against the host
    counter on the first."""
    import torch

    from malva_tpu_torch.count.device_count import (
        device_seq_sorted_counts,
        make_seq_sort_count_step,
    )
    from malva_tpu_torch.ops import kernels

    chunk, reads = read_chunk()
    seq = torch.from_numpy(chunk).to(device)
    keys, valid = kernels.seq_pack(seq, WINDOWS, REF_K)
    pk, pv = kernels.seq_pack_plain(seq, WINDOWS, REF_K)
    torch.cuda.synchronize()
    err = max_abs_err([keys >> 32, keys & 0xFFFFFFFF, valid], [pk >> 32, pk & 0xFFFFFFFF, pv])
    n_valid = int(valid.sum())
    del keys, valid, pk, pv
    if not 0 < n_valid < WINDOWS:
        raise AssertionError(f"K3 check: {n_valid} valid windows of {WINDOWS}")
    n_ragged = seq_pack_ragged(device)

    step = make_seq_sort_count_step(REF_K, WINDOWS, device)
    got_k, got_c = device_seq_sorted_counts(step, chunk)
    want_k, want_c = host_sorted_counts(reads)
    if not (np.array_equal(got_k, want_k) and np.array_equal(got_c, want_c)):
        raise AssertionError(f"device sort-count disagrees with the host counter: "
                             f"{got_k.shape[0]} vs {want_k.shape[0]} distinct keys")
    ms = cuda_ms(lambda: kernels.seq_pack(seq, WINDOWS, REF_K), iters=20)
    step_ms = cuda_ms(lambda: step(seq, WINDOWS), iters=10)
    plain_ms = cuda_ms(lambda: kernels.seq_pack_plain(seq, WINDOWS, REF_K), iters=3, warmup=1)
    # the chunk read once; per window a key of W words and a flag written,
    # and one rolling step.
    w = (REF_K + 31) // 32
    b_ms, b_by = bound(WINDOWS + REF_K - 1 + WINDOWS * (8 * w + 1), WINDOWS * rolling_ops(REF_K),
                       peak)
    log(f"K3 == plain ({n_valid} valid windows; and on {n_ragged} windows of short ragged "
        f"chunks at ref_k {list(K3_REF_KS)}); step == host sort-count ({got_k.shape[0]} "
        f"distinct keys, {int(got_c.sum())} windows); K3 {ms:.4f} ms against its bound "
        f"{b_ms:.4f} ms ({b_by}; {b_ms / ms:.1%} of the bound), step {step_ms:.4f} ms, plain K3 "
        f"{plain_ms:.4f} ms per {WINDOWS} windows")
    return {"name": "seq_pack", "route": "cuda", "source": "malva_tpu_torch/csrc/seq_count.cu",
            "replaces": "malva_tpu/count/device_count.py:64 (XLA, no Pallas counterpart)",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "step_ms": step_ms, "windows": WINDOWS,
            "ragged_windows": n_ragged, "distinct": int(got_k.shape[0])}


def genotype_phase() -> dict:
    """The f32 genotype model on 2^20 seeded variants of up to 4 alleles,
    on the card and on the CPU: the results must be identical."""
    import torch

    from malva_tpu_torch.models.genotype import make_genotype_fn

    rng = np.random.default_rng(4)
    A = 4
    n_all = rng.integers(1, A + 1, VARIANTS).astype(np.int32)
    pad = np.arange(A)[None, :] < n_all[:, None]
    cov = rng.integers(0, 80, (VARIANTS, A)).astype(np.int32) * pad
    cov[rng.random(VARIANTS) < 0.02, 0] = 250
    freqs = np.where(pad, rng.random((VARIANTS, A)), 0).astype(np.float32)
    freqs /= np.maximum(freqs.sum(axis=1, keepdims=True), np.float32(1e-9))
    args = [torch.from_numpy(a) for a in (cov, freqs, n_all)]
    out = {}
    for dev in ("cuda", "cpu"):
        fn = make_genotype_fn(A, False, 0.001, 200, dev)
        fn(*args)
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = [r.cpu().numpy() for r in fn(*args)]
        out[dev] = (res, time.perf_counter() - t0)
    diff = {name: int((a != b).sum()) for name, a, b in
            zip(("g1", "g2", "gq"), out["cuda"][0], out["cpu"][0])}
    gq_err = int(np.abs(out["cuda"][0][2].astype(np.int64) - out["cpu"][0][2]).max())
    log(f"genotype model, {VARIANTS} variants: rows that differ cuda vs cpu {diff}, "
        f"max |gq diff| {gq_err}; {out['cuda'][1]:.6g} s on the card, {out['cpu'][1]:.6g} s "
        f"on the CPU (host clock, with the copy back)")
    if any(diff.values()):
        raise AssertionError(f"genotype model: cuda and cpu differ: {diff}")
    return {"variants": VARIANTS, "cuda_s": out["cuda"][1], "cpu_s": out["cpu"][1]}


class _Tee(io.TextIOBase):
    """stderr that is also kept, to read the phase walls back."""

    def __init__(self, real):
        self.real, self.buf = real, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.real.write(s)

    def flush(self):
        self.real.flush()


def cli_leg(argv: list[str], out_path: str | None = None) -> tuple[str, float]:
    """One malva-tpu-torch command in this process -> (stderr, wall s)."""
    from malva_tpu_torch import cli

    tee = _Tee(sys.stderr)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(out_path, "w")) if out_path else None
        stack.enter_context(contextlib.redirect_stderr(tee))
        rc = cli.main(argv, out=out)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{' '.join(argv[:3])} exited {rc}")
    log(f"{' '.join(argv[:3])}: {wall:.6g} s wall")
    return tee.buf.getvalue(), wall


def stage(src: str, work: str, names: dict[str, str]) -> list[str]:
    """Private copies of the inputs (src name -> work name)."""
    os.makedirs(work)
    for a, b in names.items():
        shutil.copy(os.path.join(src, a), os.path.join(work, b))
    return [os.path.join(work, b) for b in names.values()]


def run_leg(backend: str, src: str, work: str, spill: bool = False) -> tuple[str, str, float]:
    """``run`` on a private copy of the inputs, counting through a spill
    directory inside it when ``spill`` -> (vcf path, stderr, wall)."""
    fa, vcf, fq = stage(src, work, {n: n for n in ("synth.fa", "synth.vcf", "synth.fq")})
    out = os.path.join(work, "out.vcf")
    opt = ["--spill-dir", os.path.join(work, "spill")] if spill else []
    err, wall = cli_leg(["run", "--backend", backend, "-k", str(K), "-r", str(REF_K), "-b", "1",
                         "-f", "AF", *opt, fa, vcf, fq], out)
    return out, err, wall


def batch_leg(backend: str, src: str, reads3: str, work: str,
              profile: str | None = None) -> tuple[dict, str, float]:
    """``batch`` over the 5x and 3x reads on private copies, building its
    own index, traced into ``profile`` when given -> ({file name: VCF
    bytes}, stderr, wall)."""
    fa, vcf, fq5 = stage(src, work, {"synth.fa": "synth.fa", "synth.vcf": "synth.vcf",
                                     "synth.fq": "synth.fq"})
    fq3 = os.path.join(work, "synth3x.fq")
    shutil.copy(reads3, fq3)
    out_dir = os.path.join(work, "out")
    err, wall = cli_leg(["batch", "--backend", backend, "-k", str(K), "-r", str(REF_K), "-b",
                         "1", "-f", "AF", "-o", out_dir,
                         *(["--profile-dir", profile] if profile else []), fa, vcf, fq5, fq3])
    vcfs = {n: open(os.path.join(out_dir, n), "rb").read() for n in sorted(os.listdir(out_dir))}
    if sorted(vcfs) != ["synth.malva.vcf", "synth3x.malva.vcf"]:
        raise AssertionError(f"batch --backend {backend} wrote {sorted(vcfs)}")
    return vcfs, err, wall


def phase_walls(stderr: str) -> dict:
    """PhaseTimer walls by phase (``tools/multicard_run.py phase_walls``)."""
    from malva_tpu_torch.tools.multicard_run import phase_walls as walls

    return walls(stderr)


UPLOAD = re.compile(r"index upload ([0-9.e+-]+) s \(table ([0-9.e+-]+) s, minifilter ([0-9.e+-]+) s, "
                    r"copy ([0-9.e+-]+) s, pack ([0-9.e+-]+) s\)")
UPLOAD_PARTS = ("table_s", "minifilter_s", "copy_s", "pack_s")


def upload_parts(stderr: str) -> dict:
    """The one-card index upload's wall and its four parts (s) from a leg's
    ``call step:`` metrics line (index/device.py DeviceIndex.from_host)."""
    m = UPLOAD.search(stderr)
    if m is None:
        raise AssertionError("the leg logged no index upload split into its four parts")
    return {"upload_s": float(m.group(1)), **dict(zip(UPLOAD_PARTS, map(float, m.groups()[1:])))}


def host_phases(walls: dict) -> dict:
    """The two host phases the native library's threads serve, from a
    leg's phase walls: the variant pass of the index (its heartbeats and
    final line) and pass 2 (coverage, genotyping, VCF)."""
    return {"variant_pass_s": round(sum(v for n, v in walls.items()
                                        if n.startswith("Processed variants")), 6),
            "pass2_s": sum(v for n, v in walls.items() if n.startswith("VCF parsing and genotyping"))}


def trace_summary(trace_dir: str) -> dict:
    """Device time by kernel from the torch.profiler trace of a leg: the
    summed durations of each kernel of the port (ms), of all kernels and
    copies, and the device's busy share of the traced window."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    if len(files) != 1:
        raise AssertionError(f"--profile-dir wrote {files}, not one trace")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    out = {"trace_events": len(events), "device_events": len(device)}
    if not device:
        out["device"] = "not measured: the trace holds no device activity"
        return out
    for name in ("callstep_kernel", "ref_scan_kernel", "seq_pack_kernel"):
        out[f"{name}_ms"] = sum(e["dur"] for e in device if name in e["name"]) / 1e3
    busy = sum(e["dur"] for e in device)
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    out.update({"device_busy_ms": busy / 1e3, "traced_window_s": span / 1e6,
                "device_busy_share": busy / span,
                "kernels_ms": sum(e["dur"] for e in device if e["cat"] == "kernel") / 1e3})
    return out


SINGLE = ("callstep", "ref_scan", "seq_pack")  # kernels of the one-device legs
ROUTED_KERNELS = ("shard_update", "route_pack", "route_probe", "shard_update_slots")
SCAN_KERNELS = ("scan_pack", "scan_set")  # the sharded context scan's
CHUNKS_READ_NOTHING = "host reads 0 in the chunks"  # the sharded context scan's line says so


def check_launches(name: str, launches: dict, kernels=SINGLE) -> None:
    for kernel in kernels:
        if launches[kernel] <= 0:
            raise AssertionError(f"kernel {kernel} did not launch in the {name}")


def lib_leg(name: str, fn) -> tuple[str, float]:
    """fn(timer) in this process with stderr kept -> (stderr, wall s)."""
    from malva_tpu_torch.utils.timing import PhaseTimer

    tee = _Tee(sys.stderr)
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(tee):
        fn(PhaseTimer("malva-tpu-torch", out=sys.stderr))
    wall = time.perf_counter() - t0
    log(f"{name}: {wall:.6g} s wall")
    return tee.buf.getvalue(), wall


def sharded_legs(src: str, reads3: str, work: str, run_vcf: bytes, batch_vcfs: dict) -> dict:
    """``build_index`` + ``call`` through the port's library with a mesh of
    SHARDS virtual shards of the one card, then ``call_batch`` with the
    same mesh over the 5x and 3x reads on that index: the VCFs must equal
    the host legs', and K1 (hash-only), K3, K4, K6, K7, K8 and K9 must
    have launched, and the sharded context scan must log no host read in
    its chunks."""
    import torch

    from malva_tpu_torch import cli, pipeline
    from malva_tpu_torch.ops import kernels
    from malva_tpu_torch.parallel.mesh import make_mesh

    fa, vcf, fq = stage(src, work, {n: n for n in ("synth.fa", "synth.vcf", "synth.fq")})
    fq3 = os.path.join(work, "synth3x.fq")
    shutil.copy(reads3, fq3)
    cfg = cli._config(cli._parser().parse_args(["run", "--backend", "cuda", "-k", str(K), "-r",
                                            str(REF_K), "-b", "1", "-f", "AF", fa, vcf, fq]))
    mesh = make_mesh(devices=[torch.device("cuda", 0)] * SHARDS)
    out = os.path.join(work, "out.vcf")
    got: dict = {}

    def run(timer):
        got["index"] = pipeline.build_index(cfg, timer, mesh=mesh)
        with open(out, "w") as f:
            got["stats"] = pipeline.call(cfg, got["index"], f, timer, mesh=mesh)

    kernels.reset_launches()
    err, wall = lib_leg(f"sharded run over {SHARDS} virtual shards", run)
    launches = dict(kernels.LAUNCHES)
    if open(out, "rb").read() != run_vcf:
        raise AssertionError("the sharded run's VCF differs from the host run's")
    check_launches("sharded run", launches, ("callstep", "seq_pack") + SCAN_KERNELS
                   + ROUTED_KERNELS)
    for line in ("sharded context scan", CHUNKS_READ_NOTHING, "sharded call step"):
        if line not in err:
            raise AssertionError(f"the sharded run logged no '{line}'")
    stats = got["stats"]
    log(f"sharded run VCF == host run's; launches {launches}; call step {json.dumps(stats)}")
    gather = gather_leg(cfg, got["index"], mesh, fq, os.path.join(work, "gather.vcf"), run_vcf)

    outs = [os.path.join(work, n) for n in ("synth.malva.vcf", "synth3x.malva.vcf")]

    def batch(timer):
        with contextlib.ExitStack() as stack:
            files = [stack.enter_context(open(o, "w")) for o in outs]
            pipeline.call_batch(cfg, got["index"], [fq, fq3], files, timer, mesh=mesh)

    kernels.reset_launches()
    berr, bwall = lib_leg("sharded call_batch", batch)
    batch_launches = dict(kernels.LAUNCHES)
    for o in outs:
        if open(o, "rb").read() != batch_vcfs[os.path.basename(o)]:
            raise AssertionError(f"sharded call_batch: {os.path.basename(o)} differs from the "
                                 f"host batch leg's")
    check_launches("sharded call_batch", batch_launches, ("callstep", "seq_pack") + ROUTED_KERNELS)
    if berr.count("sharded index uploaded") != 1:
        raise AssertionError("sharded call_batch did not place the sharded index once")
    log(f"sharded call_batch VCFs == host batch leg's; launches {batch_launches}")
    alone = upload_alone(got["index"], cfg)
    return {"upload_alone": alone, "launches": launches, "batch_launches": batch_launches,
            "gather_launches": gather.pop("launches"), "call_step": stats, "gather": gather,
            "walls": {"sharded run": phase_walls(err), "sharded batch": phase_walls(berr)},
            "legs_s": {"sharded run": wall, "sharded batch": bwall,
                       "sharded gather call": gather["wall_s"]}}


def gather_leg(cfg, index, mesh, fq: str, out: str, run_vcf: bytes) -> dict:
    """The all-gather design on the chr-scale index the sharded run built
    and called: the run's counters are kept, zeroed, the reads counted
    again on the card, and the counter's batches stepped through
    ``ShardedCallSession(routed=False)`` (``apply_sample_counts_sharded``)
    on the same SHARDS virtual shards.  Its bf.counts and exact map must
    equal the routed session's, K1 and K5 must have launched, and the VCF
    genotyped from it must equal the host run's."""
    from malva_tpu_torch import pipeline
    from malva_tpu_torch.io.fasta import load_reference
    from malva_tpu_torch.ops import kernels
    from malva_tpu_torch.parallel.sharded_index import apply_sample_counts_sharded
    from malva_tpu_torch.utils.timing import PhaseTimer

    routed_counts, routed_kmers = index.bf.counts.copy(), dict(index.ref_bf.kmers)
    pipeline._reset_counters(index)
    contexts, counts = pipeline._sample_kmers(cfg, fq, mesh[0])
    tee = _Tee(sys.stderr)
    t0 = time.perf_counter()
    kernels.reset_launches()
    with contextlib.redirect_stderr(tee):
        stats = apply_sample_counts_sharded(index, contexts, counts, cfg, mesh, routed=False)
        apply_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        with open(out, "w") as f:
            pipeline._genotype_and_emit(cfg, index, load_reference(cfg.fasta_path, cfg.strip_chr),
                                        f, PhaseTimer("malva-tpu-torch", out=sys.stderr))
    wall = time.perf_counter() - t0
    if not (np.array_equal(index.bf.counts, routed_counts) and index.ref_bf.kmers == routed_kmers):
        raise AssertionError("the all-gather session's counters differ from the routed session's")
    check_launches("sharded gather call", launches, ("callstep", "gather_update"))
    if open(out, "rb").read() != run_vcf:
        raise AssertionError("the all-gather session's VCF differs from the host run's")
    log(f"sharded gather call ({SHARDS} virtual shards): counters == routed session's, VCF == "
        f"host run's, {wall:.6g} s wall, the apply {apply_s:.6g} s of it; launches {launches}; "
        f"call step {json.dumps(stats)}")
    return {"launches": launches, "call_step": stats, "wall_s": wall, "apply_s": apply_s}


def upload_alone(index, cfg) -> dict:
    """The one-card index upload (DeviceIndex.from_host) of a chr-scale
    host index with nothing else running in the process: its wall and its
    four parts (s)."""
    import torch

    from malva_tpu_torch.index.device import DeviceIndex

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = DeviceIndex.from_host(index, cfg, torch.device("cuda", 0))
    out = {"upload_s": time.perf_counter() - t0, **dev.upload_parts}
    del dev
    torch.cuda.empty_cache()
    log(f"one-card index upload alone: {json.dumps(out)}")
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def distributed_leg(src: str, work: str, run_vcf: bytes) -> dict:
    """``python -m malva_tpu_torch.run_distributed`` in two processes on the
    chr-scale genome and VCF, the 5x reads split into two FASTQ files:
    rank 0's VCF must equal the host run's."""
    fa, vcf, fq = stage(src, work, {n: n for n in ("synth.fa", "synth.vcf", "synth.fq")})
    with open(fq, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    parts = [os.path.join(work, f"reads{i}.fq") for i in range(2)]
    for i, path in enumerate(parts):
        with open(path, "wb") as f:
            for r in range(4 * i, len(lines), 8):  # every other 4-line record
                f.writelines(lines[r : r + 4])
    del lines
    out = os.path.join(work, "out.vcf")
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs, errs = [], [os.path.join(work, f"err{i}.txt") for i in range(2)]
    t0 = time.perf_counter()
    try:
        for i in range(2):
            with open(errs[i], "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "malva_tpu_torch.run_distributed", "--coordinator",
                     f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(i),
                     "--out", out, "--timeout", "600", "-k", str(K), "-r", str(REF_K), "-b", "1",
                     "-f", "AF", fa, vcf, *parts], cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                    stderr=err))
        rcs = [p.wait(timeout=700) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    texts = [open(e).read() for e in errs]
    if rcs != [0, 0]:
        raise RuntimeError(f"run_distributed exited {rcs}: {texts[0][-2000:]}{texts[1][-2000:]}")
    if open(out, "rb").read() != run_vcf:
        raise AssertionError("the two-process run's VCF differs from the host run's")
    exchange = [ln for t in texts for ln in t.splitlines() if "exchange" in ln]
    log(f"two-process run_distributed VCF == host run's, {wall:.6g} s wall; {exchange}")
    return {"wall_s": wall, "exchange": exchange,
            "walls": [phase_walls(t) for t in texts]}


def host_cards() -> tuple[int, str | None]:
    """The cards this process may use (``nvidia-smi -L``, or the given
    ``CUDA_VISIBLE_DEVICES``) and that variable as given.  Where there are
    two or more, this process keeps to the first of them, set before CUDA
    starts: the real-card leg runs in processes of its own, and every
    other leg runs as on a one-card host."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    smi = shutil.which("nvidia-smi")
    listed = subprocess.run([smi, "-L"], capture_output=True, text=True).stdout if smi else ""
    n = len(visible.split(",")) if visible else sum(ln.startswith("GPU ") for ln in
                                                    listed.splitlines())
    if n >= 2:
        os.environ["CUDA_VISIBLE_DEVICES"] = (visible or "0").split(",")[0]
    return n, visible


def real_cards_leg(src: str, work: str, run_vcf: bytes, cards: int, visible: str | None) -> dict:
    """The chr-scale ``run --backend cuda`` with every card visible (the
    default route shards over all of them: ``backend.mesh_for``) and with
    the first alone, and on a host of three cards or more also with the
    first two, each in its own process: every VCF must equal the host
    run's, and each sharded run must have logged the sharded context scan
    with its upload and scan, the sharded call step with no host read in
    its steps, and the cards' start-up.  Needs two cards or more."""
    from malva_tpu_torch.tools.multicard_run import run_once

    if cards < 2:
        log(f"real-card leg: skipped, it needs two cards or more and this host has {cards}")
        return {"skipped": f"{cards} card"}
    out = {}
    ids = (visible or ",".join(map(str, range(cards)))).split(",")
    legs = [("all", visible), ("one", ids[0])] + ([("two", ",".join(ids[:2]))] if cards >= 3
                                                  else [])
    for label, vis in legs:
        r = run_once(REPO, src, os.path.join(work, label), vis, label)
        if open(r.pop("vcf"), "rb").read() != run_vcf:
            raise AssertionError(f"the real-card run on {label} card(s) differs from the host run")
        log(f"real-card leg, {label} card(s): {r['wall_s']:.6g} s wall, VCF == host run's; "
            f"phases {json.dumps(r['phases'])}")
        for line in r["metrics"]:
            log(f"real-card leg, {label} card(s): {line}")
        out[label] = r
    for label in ("all", "two"):
        lines = "\n".join(out[label]["metrics"]) if label in out else None
        for want in ("sharded context scan", CHUNKS_READ_NOTHING, "none in the steps",
                     "card start-up"):
            if lines is not None and want not in lines:
                raise AssertionError(f"the real-card run on {label} cards logged no '{want}'")
    return out


def main_path_phase(cards: int, visible: str | None, parent: str | None = None) -> dict:
    from malva_tpu_torch.graft_entry import dryrun_multichip
    from malva_tpu_torch.ops import kernels
    from malva_tpu_torch.utils import native

    tmp = tempfile.mkdtemp(prefix="malva_smoke_")
    try:
        # the 5x and the 3x inputs side by side; the generator draws the
        # reads last, so the genome and the VCF of the two are the same
        src, src3 = os.path.join(tmp, "in"), os.path.join(tmp, "in3")
        t0 = time.perf_counter()
        gens = [subprocess.Popen([sys.executable, os.path.join(REPO, "tools", "make_synth_scale.py"),
                                  d, *SYNTH, "--coverage", cov])
                for d, cov in ((src, "5"), (src3, "3"))]
        if any(g.wait() != 0 for g in gens):
            raise RuntimeError("tools/make_synth_scale.py failed")
        for name in ("synth.fa", "synth.vcf"):
            if not filecmp.cmp(os.path.join(src, name), os.path.join(src3, name), shallow=False):
                raise AssertionError(f"the 3x input's {name} differs from the 5x input's")
        log(f"chr-scale inputs (5x and 3x reads) generated in {time.perf_counter() - t0:.6g} s")

        kernels.reset_launches()
        vcf_cuda, err_cuda, wall_cuda = run_leg("cuda", src, os.path.join(tmp, "cuda"))
        launches = dict(kernels.LAUNCHES)
        vcf_host, err_host, wall_host = run_leg("host", src, os.path.join(tmp, "host"))

        a, b = open(vcf_cuda, "rb").read(), open(vcf_host, "rb").read()
        if a != b:
            raise AssertionError(f"cuda and host VCFs differ ({len(a)} vs {len(b)} bytes)")
        n_rec = sum(1 for ln in a.splitlines() if not ln.startswith(b"#"))
        if n_rec < MIN_RECORDS:
            raise AssertionError(f"only {n_rec} VCF records")
        check_launches("cuda run", launches)
        if "counting overlapped" in err_cuda or "sort-count on cuda" not in err_cuda:
            raise AssertionError("the cuda run did not count the reads on the card")

        # the cuda run again, counting through a spill directory: the device
        # spill counter (one segment per piece, a manifest per read batch)
        kernels.reset_launches()
        vcf_spill, err_spill, wall_spill = run_leg("cuda", src, os.path.join(tmp, "spill"),
                                                   spill=True)
        spill_launches = dict(kernels.LAUNCHES)
        if open(vcf_spill, "rb").read() != b:
            raise AssertionError("the cuda run with --spill-dir differs from the host run")
        check_launches("cuda run with --spill-dir", spill_launches)
        if ("counting overlapped" in err_spill
                or not re.search(r"\[malva-tpu-torch/spill\] .*sort-count on cuda", err_spill)):
            raise AssertionError("the cuda run with --spill-dir did not count on the card")
        log(f"run --spill-dir VCF == host run's; launches {spill_launches}")
        walls = {"run cuda": phase_walls(err_cuda), "run host": phase_walls(err_host),
                 "run cuda spill": phase_walls(err_spill)}
        upload = upload_parts(err_cuda)
        threads = {leg: host_phases(w) for leg, w in walls.items()}
        log(f"cuda run's index upload {json.dumps(upload)}; host phases with the native "
            f"library's {native.threads()} threads: {json.dumps(threads)}")
        m = re.search(r"call step: (\d+) distinct k-mers in (\d+) steps, "
                      r"step time ([0-9.e+-]+) ms", err_cuda)
        if m is None:
            raise AssertionError("the cuda run logged no call-step line")
        rows, ms = int(m.group(1)), float(m.group(3))
        log(f"run VCFs byte-identical ({n_rec} records); launches {launches}")
        log(f"call step: {rows} distinct k-mers, {ms} ms step time (K1 launcher events), "
            f"{rows / (ms / 1e3):.6g} k-mers/s")
        if ms >= 10:
            raise AssertionError(f"the cuda run's logged call-step time {ms} ms is not under "
                                 f"10 ms: the launcher events measure more than the kernel")

        reads3 = os.path.join(src3, "synth.fq")
        kernels.reset_launches()
        prof = os.path.join(tmp, "trace")
        out_cuda, berr_cuda, bwall_cuda = batch_leg("cuda", src, reads3, os.path.join(tmp, "bc"),
                                                    prof)
        batch_launches = dict(kernels.LAUNCHES)
        out_host, berr_host, bwall_host = batch_leg("host", src, reads3, os.path.join(tmp, "bh"))
        if out_cuda != out_host:
            raise AssertionError("batch: cuda and host VCFs differ for "
                                 f"{[n for n in out_cuda if out_cuda[n] != out_host.get(n)]}")
        if out_cuda["synth.malva.vcf"] != a:
            raise AssertionError("batch: the 5x sample's VCF differs from the run VCF")
        if out_cuda["synth.malva.vcf"] == out_cuda["synth3x.malva.vcf"]:
            raise AssertionError("batch: the 5x and 3x VCFs are equal")
        check_launches("cuda batch", batch_launches)
        n_up = len(re.findall(r"device index uploaded", berr_cuda))
        if n_up != 1:
            raise AssertionError(f"batch: the device index was uploaded {n_up} times")
        walls.update({"batch cuda": phase_walls(berr_cuda), "batch host": phase_walls(berr_host)})
        trace = trace_summary(prof)
        log(f"batch --backend cuda under torch.profiler: {json.dumps(trace)}")
        log(f"batch VCFs byte-identical per sample, 5x == run; launches {batch_launches}; "
            f"one device index upload")
        legs = {"run cuda": wall_cuda, "run host": wall_host, "run cuda spill": wall_spill,
                "batch cuda": bwall_cuda, "batch host": bwall_host}

        sharded = sharded_legs(src, reads3, os.path.join(tmp, "sharded"), b, out_host)
        upload_alone = sharded.pop("upload_alone")
        walls.update(sharded["walls"])
        legs.update(sharded["legs_s"])
        ab = parent_runs(parent, src, os.path.join(tmp, "ab"), b) if parent else None
        dist = distributed_leg(src, os.path.join(tmp, "dist"), b)
        legs["run_distributed 2 processes"] = dist["wall_s"]
        t0 = time.perf_counter()
        dryrun_multichip(SHARDS, ["cuda:0"] * SHARDS)
        legs["dryrun_multichip"] = time.perf_counter() - t0
        real = real_cards_leg(src, os.path.join(tmp, "real"), b, cards, visible)
        for label in ("all", "two", "one"):
            if label in real:
                legs[f"run cuda, {label} card(s), own process"] = real[label]["wall_s"]
                walls[f"run cuda, {label} card(s)"] = real[label]["phases"]
        log(f"phase walls in s: {json.dumps(walls)}")
        return {"launches": launches, "spill_launches": spill_launches,
                "batch_launches": batch_launches, "sharded_launches": sharded["launches"],
                "sharded_batch_launches": sharded["batch_launches"],
                "gather_launches": sharded["gather_launches"], "records": n_rec,
                "distinct_kmers": rows, "call_step_event_ms": ms, "walls": walls,
                "upload": {"run cuda": upload, "alone": upload_alone},
                "host_phases": {"threads": native.threads(), **threads},
                "batch_trace": trace, "sharded_call_step": sharded["call_step"],
                "sharded_gather": sharded["gather"],
                "distributed": dist, "real_cards": real, "legs_s": legs, "parent_runs": ab}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def module_json(argv: list[str], env: dict, timeout: int) -> dict:
    """Run ``python -m <module> ...`` from the checkout, its stderr passed
    on; the JSON object of its last stdout line."""
    p = subprocess.run([sys.executable, "-m", *argv], cwd=REPO, env=dict(os.environ, **env),
                       stdout=subprocess.PIPE, text=True, timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError(f"python -m {argv[0]} exited {p.returncode}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def tools_phase() -> dict:
    """The port's two measurement tools on the card: the shard-scaling
    tool (both designs at D = 1, 2, 4 virtual shards, 2^33 bits, a 2^21
    batch; it exits non-zero unless every run leaves the same state) and
    the headline bench
    (wgs mode: 2^33 bits, a 10M-key map, with the single-thread C++
    baseline).  Each runs in its own process."""
    t0 = time.perf_counter()
    scaling = module_json(["malva_tpu_torch.tools.scaling_mesh", "--log2-bits", "33", "--batch",
                           str(LANES), "--shards", f"1,2,{SHARDS}"], {}, timeout=400)
    scaling_s = time.perf_counter() - t0
    if len(scaling["runs"]) != 6:
        raise AssertionError(f"scaling tool: {len(scaling['runs'])} runs, not 6")
    log(f"scaling tool: {json.dumps(scaling)} ({scaling_s:.6g} s)")
    t0 = time.perf_counter()
    bench = module_json(["malva_tpu_torch.bench"], {"MALVA_BENCH_MODE": "wgs",
                                                    "MALVA_BENCH_MACHINE": "0"}, timeout=500)
    bench_s = time.perf_counter() - t0
    missing = [k for k in ("metric", "value", "unit", "vs_baseline", "baseline_single_thread",
                           "baseline_machine", "vs_machine", "baseline_hash") if k not in bench]
    if missing or not bench["value"] > 0 or not bench["baseline_single_thread"] > 0:
        raise AssertionError(f"bench: keys missing {missing} or no rate: {bench}")
    log(f"bench ({bench_s:.6g} s): {json.dumps(bench)}")
    return {"scaling": scaling, "bench": bench, "legs_s": {"scaling tool": scaling_s,
                                                           "bench": bench_s}}


def ptxas_check(log_text: str) -> dict:
    """Per kernel of K1-K9 (csrc/), from this build's ptxas report: its
    instantiations and their registers.  Raises unless every
    instantiation was compiled with a 0-byte stack frame and no spill
    store or load: the per-lane state must live in registers."""
    from malva_tpu_torch.ops import _build

    report = _build.ptxas_report(log_text)
    out: dict = {}
    for r in report:
        n = re.search(r"ILi(\d+)E", r["function"])
        log(f"ptxas: {r['kernel'] or r['function']}{f'<{n.group(1)}>' if n else ''}: "
            f"{r['registers']} registers, {r['stack']} bytes stack frame, {r['spill_stores']} "
            f"bytes spill stores, {r['spill_loads']} bytes spill loads")
        if r["kernel"] is not None:
            e = out.setdefault(r["kernel"], {"instantiations": 0, "registers": []})
            e["instantiations"] += 1
            e["registers"].append(r["registers"])
    bad = [r for r in report if r["kernel"] and (r["stack"] or r["spill_stores"]
                                                 or r["spill_loads"])]
    missing = [k for k in _build.KERNELS if k not in out]
    if bad or missing:
        worst = [(r["function"], r["stack"], r["spill_stores"], r["spill_loads"]) for r in bad]
        raise AssertionError(f"ptxas: kernels missing from the report {missing}; stack frames "
                             f"or spills (function, stack, spill stores, spill loads) {worst}")
    summary = {k: {"instantiations": e["instantiations"], "registers_min": min(e["registers"]),
                   "registers_max": max(e["registers"]), "stack_bytes": 0, "spill_bytes": 0}
               for k, e in out.items()}
    log(f"ptxas: 0-byte stack frames and no spills in all {len(report)} entries; {summary}")
    return summary


def ensure_native() -> str:
    """Build the port's native host library for this machine from its own
    source (``malva_tpu_torch/csrc/host_kernels.cpp``) and load it
    (``malva_tpu_torch.utils.native``: -fopenmp, else -fopenmp against
    torch's libgomp, else one thread).  Fails unless it loads and, on a
    host with more than one core, runs its loops on more than one thread:
    without it the host layers fall back to Python, and on one thread the
    host phases run slower."""
    from malva_tpu_torch.utils import native

    lib = native.load()
    if lib is None:
        raise AssertionError("the native host library did not load")
    threads, form = native.threads(), native.build_form()
    if threads <= 1 < (os.cpu_count() or 1):
        raise AssertionError(f"the native host library (form {form}) runs on {threads} thread "
                             f"on a host with {os.cpu_count()} cores")
    return f"form {form}, {threads} threads, {os.cpu_count()} cores, loaded from {lib._name}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (no main-path run, no ok line)")
    ap.add_argument("--parent", default=None,
                    help="another checkout: also time its K4 slot entry, K6, K7, K8 and K9, "
                         "and (without --kernels-only) its scan alone and sharded run, in turns "
                         "with this one's")
    args = ap.parse_args()
    cards, visible = host_cards()
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
    native_facts = ensure_native()
    log(f"native host library: {native_facts}")

    t0 = time.perf_counter()
    _build.library(fresh=True)
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.6g} s")
    for line in _build.build_log.splitlines():
        if line.startswith("nvcc ") or "error" in line.lower():
            log(line.strip())
    ptxas = ptxas_check(_build.build_log)

    walls = {"kernel build": build_s}
    parent = None
    if args.parent:
        t0 = time.perf_counter()
        parent = _build.library_at(Path(args.parent).resolve() / "malva_tpu_torch" / "csrc")
        log(f"{args.parent}'s kernels built in {time.perf_counter() - t0:.6g} s")
    t0 = time.perf_counter()
    results = kernel_phase(torch.device("cuda"), parent)
    walls["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    genotype = genotype_phase()
    walls["genotype model"] = time.perf_counter() - t0
    main = tools = None
    if not args.kernels_only:
        t0 = time.perf_counter()
        main = main_path_phase(cards, visible, args.parent and str(Path(args.parent).resolve()))
        walls["main paths"] = time.perf_counter() - t0
        walls.update(main["legs_s"])
        tools = tools_phase()
        walls.update(tools["legs_s"])
    legs = ("launches", "spill_launches", "batch_launches", "sharded_launches",
            "sharded_batch_launches", "gather_launches")
    for r in results:
        # "launches": the first leg whose path runs the kernel (K4: the
        # sharded run; K5: the all-gather call on the sharded run's index)
        first = {"gather_update": "gather_launches",
                 **dict.fromkeys(ROUTED_KERNELS + SCAN_KERNELS, "sharded_launches")
                 }.get(r["name"], "launches")
        r["launches"] = main[first][r["name"]] if main else None
        r["launches_by_leg"] = {leg: main[leg][r["name"]] for leg in legs} if main else None
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
    print(json.dumps({"phase_walls_s": walls, "ptxas": ptxas, "genotype": genotype,
                      "native": native_facts,
                      "upload": main and main["upload"],
                      "host_phases": main and main["host_phases"],
                      "sharded_call_step": main and main["sharded_call_step"],
                      "sharded_gather": main and main["sharded_gather"],
                      "scaling": tools and tools["scaling"],
                      "real_cards": main and main["real_cards"],
                      "distributed": main and main["distributed"],
                      "parent_runs": main and main["parent_runs"]}), flush=True)
    if tools:
        print(json.dumps(tools["bench"]), flush=True)
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
