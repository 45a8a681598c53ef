"""Shard-count scaling of the two sharded call steps, routed and all-gather.

Counterpart of ``tools/scaling_mesh.py``: the same experiment on the
port.  A seeded index (the port's host ``BF`` and ``KMAP``: 200k alt
k-mers, 100k exact-map keys, 50k contexts), one fixed GLOBAL batch of
random canonical contexts, and both designs at D = 1, 2, 4, 8 shards where
the mesh allows: the routed step (``parallel/sharded_index.py
Router.step``: K1 hash-only and K6 on each source slice, hop 1's slot
copies, K7 on the context-word owners, hop 2's copies, K4's slot entry on
the Bloom-word owners; O(B/D) work per shard, no host read in a step)
and the all-gather step (``gather_step``: every shard gets the whole
batch, hashes it with K1 hash-only and applies it with K5; O(B) work per
shard).  Each line gives ms per batch (host clock over the timed steps
and, for the routed step, the router's drain, its one host read and the
rerun of any overflowed rows, ending in a synchronize), the host's time
to issue the steps, M k-mers/s, the kernels' device time
from their launchers' events, and the speed-up against D = 1; every run
must leave the same counters and map values (written back), or the tool
fails.

    python -m malva_tpu_torch.tools.scaling_mesh                     # cuda, 2^26 bits, 2^17 batch
    python -m malva_tpu_torch.tools.scaling_mesh --log2-bits 33 --batch 2097152
    python -m malva_tpu_torch.tools.scaling_mesh --device cpu --shards 1,2

What the curve shows depends on the mesh.  With D cards on the host the D
shards go one to a card, and the curve is scaling across cards.  On a
host with one card (or under ``CUDA_VISIBLE_DEVICES=0`` on a host with
more) the D shards are virtual shards of that one card, run one after
another by one process: the curve then
shows per-shard work, how the work each shard does shrinks (routed) or
stays (all-gather) as D grows, and not scaling across cards; a flat
routed curve there is the ideal.  On the CPU the kernels take their plain
versions, and the times are the CPU's, not a device's.

The batch's contexts are uploaded to the shards once, before the timed
steps, so the times are the steps' own (the JAX tool hands its step the
same host batch each time).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

K, REF_K = 35, 43
N_ALT, N_MAP, N_CTX = 200_000, 100_000, 50_000
ITERS = 6  # timed steps per design and D


def seeded_index(log2_bits: int, seed: int = 0):
    """The tool's index, made with the port's host BF and KMAP."""
    from ..index.bloom_filter import BF
    from ..index.kmap import KMAP
    from ..pipeline import Index
    from ..utils.config import Config

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    cfg = Config(k=K, ref_k=REF_K, bf_size=1 << log2_bits)
    bf, ref_bf, ctx = BF(cfg.bf_size), KMAP(), BF(cfg.bf_size)
    bf.add_keys(alpha[rng.integers(0, 4, size=(N_ALT, K))])
    ref_bf.add_keys(alpha[rng.integers(0, 4, size=(N_MAP, K))])
    ctx.add_keys(alpha[rng.integers(0, 4, size=(N_CTX, REF_K))])
    bf.switch_mode()
    ctx.switch_mode()
    return Index(bf=bf, ref_bf=ref_bf, context_bf=ctx), cfg, rng


def mesh_of(device: torch.device, d: int):
    """The D-shard mesh, and whether its shards are virtual (one device
    repeated), or None where the host has too few cards for D."""
    if device.type != "cuda" or torch.cuda.device_count() == 1:
        return (device,) * d, True
    if d > torch.cuda.device_count():
        return None, False
    return tuple(torch.device("cuda", i) for i in range(d)), False


def run_design(index, cfg, mesh, routed: bool, packed: np.ndarray,
               counters: np.ndarray) -> dict:
    """One warm-up step and ITERS timed steps of one design over the
    batch, then the state written back into ``index`` (counters zeroed
    first).  Returns the times and the written-back state."""
    from ..index.device import events_ms
    from ..ops.bloom import from_u32
    from ..parallel.sharded_index import (
        Router,
        gather_step,
        routed_step,
        row_stats,
        shard_index,
        shard_index_routed,
    )
    from ..pipeline import _reset_counters

    _reset_counters(index)
    t0 = time.perf_counter()
    sharded = (shard_index_routed if routed else shard_index)(index, cfg, mesh)
    place_s = time.perf_counter() - t0
    S = len(mesh)
    n = packed.shape[0]
    bounds = [n * s // S for s in range(S + 1)]
    ctx = [from_u32(packed[a:b], d) for a, b, d in zip(bounds, bounds[1:], mesh)]
    cnt = [from_u32(counters[a:b], d) for a, b, d in zip(bounds, bounds[1:], mesh)]
    kernel = "shard_update" if routed else "gather_update"
    stats = row_stats(routed, S)
    router = Router(sharded, mesh, max(c.shape[0] for c in ctx)) if routed else None

    def step(*args):
        if routed:
            routed_step(*args, router=router)
        else:
            gather_step(*args)
    cuda = mesh[0].type == "cuda"

    def sync():
        if cuda:
            for dev in dict.fromkeys(mesh):
                torch.cuda.synchronize(dev)

    def drain():
        if routed:
            router.drain(stats)

    step(sharded, mesh, ctx, cnt, stats)  # warm-up
    drain()
    sync()
    events = {"callstep_hash": [], kernel: []} if cuda else None
    t0 = time.perf_counter()
    for _ in range(ITERS):
        step(sharded, mesh, ctx, cnt, stats, events)
    issued = (time.perf_counter() - t0) / ITERS
    drain()
    sync()
    dt = (time.perf_counter() - t0) / ITERS
    sharded.write_back(index)
    return {"ms_per_batch": dt * 1e3, "issue_ms_per_batch": issued * 1e3,
            "mkmers_per_s": n / dt / 1e6,
            "k1_ms_per_batch": events and events_ms(events["callstep_hash"]) / ITERS,
            "kernel_ms_per_batch": events and events_ms(events[kernel]) / ITERS,
            "place_s": place_s, "rows": stats,
            "state": (index.bf.counts.copy(), dict(index.ref_bf.kmers))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--log2-bits", type=int, default=26, help="Bloom filter bits, log2")
    ap.add_argument("--batch", type=int, default=1 << 17, help="global batch (contexts)")
    ap.add_argument("--shards", default="1,2,4,8", help="shard counts D, comma-separated")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("scaling_mesh: no CUDA device (pass --device cpu for the CPU)")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)

    from ..index.device import pack2bit_u32_np
    from ..ops.seq import canonical

    t0 = time.perf_counter()
    index, cfg, rng = seeded_index(args.log2_bits)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    packed = pack2bit_u32_np(canonical(alpha[rng.integers(0, 4, size=(args.batch, REF_K))]),
                             REF_K)
    counters = np.ones(args.batch, dtype=np.uint32)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (plain "
             "versions of the kernels)")
    print(f"[scale] {where}; {torch.cuda.device_count() if device.type == 'cuda' else 0} cards; "
          f"2^{args.log2_bits} bits, global batch {args.batch}, {ITERS} timed steps; index "
          f"made in {time.perf_counter() - t0:.3f} s", file=sys.stderr)

    results, first = {}, None
    for d in (int(x) for x in args.shards.split(",")):
        mesh, virtual = mesh_of(device, d)
        if mesh is None:
            print(f"[scale] D={d}: skipped, the host has fewer cards", file=sys.stderr)
            continue
        for kind, routed in (("routed", True), ("gather", False)):
            r = run_design(index, cfg, mesh, routed, packed, counters)
            counts, kmers = r.pop("state")
            if first is None:
                first = (counts, kmers)
            elif not (np.array_equal(counts, first[0]) and kmers == first[1]):
                raise AssertionError(f"{kind} D={d} left other counters than the first run")
            r.update(virtual=virtual, shards=d)
            results[(kind, d)] = r
            print(f"[scale] {kind:6s} D={d} ({'virtual' if virtual else 'cards'}): "
                  f"{r['ms_per_batch']:9.3f} ms/batch ({r['mkmers_per_s']:8.2f} M/s; the host "
                  f"issued it in {r['issue_ms_per_batch']:.3f} ms); device time "
                  f"K1 hash-only {r['k1_ms_per_batch']} ms, {'K4' if routed else 'K5'} "
                  f"{r['kernel_ms_per_batch']} ms per batch (launcher events); placement "
                  f"{r['place_s']:.3f} s", file=sys.stderr)
    speedup = {}
    for kind in ("routed", "gather"):
        if (kind, 1) in results:
            base = results[(kind, 1)]["ms_per_batch"]
            speedup[kind] = {d: base / r["ms_per_batch"] for (k, d), r in results.items()
                             if k == kind}
            print(f"[scale] {kind} speed-up vs D=1: "
                  f"{ {d: round(v, 3) for d, v in speedup[kind].items()} }", file=sys.stderr)
    print(json.dumps({"device": where, "log2_bits": args.log2_bits, "batch": args.batch,
                      "iters": ITERS, "speedup_vs_d1": speedup,
                      "runs": [{"design": k, **{n: v for n, v in r.items() if n != "rows"}}
                               for (k, _), r in results.items()]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
