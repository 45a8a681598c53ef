"""Hash-range-sharded device index and the routed call step over a mesh.

Counterpart of ``malva_tpu/parallel/sharded_index.py``, routed design
(``:197-516``, ``:519-737``), which is what ``malva_tpu``'s product path
runs whenever more than one device is attached.  The layout is JAX's:
shard s of a mesh of S owns Bloom words ``[s * W/S, (s + 1) * W/S)``, as a
(W/S, 2) [word, local rank] array, its counters (padded to the longest
shard), the same range of context words, and an exact map of the keys
whose Bloom word it owns, as a bucket table of ``nbs`` buckets (the same
on every shard).  The bucket tables are built with numpy on the host, as
JAX does; the rank rows are built on each shard's device from its
uploaded words.  Unlike JAX's rows, the port's carry the shard's own
exact-map mini-filter in the local rank's top 4 bits, as the one-device
rows do (``index/device.py``), so that K4 probes the map only for the few
lanes it lets through; a shard whose counters reach 2^28, or an index
placed from JAX's arrays, has none (``ShardedIndex.minifilter``).

The routed step (JAX ``make_routed_call_step``): each source shard hashes
its slice of the batch with K1's hash-only mode; hop 1 sends each lane to
the owner of its context word, which tests the context-filter bit with a
gather; hop 2 sends it on to the owner of its centre's Bloom word,
carrying that bit, and the owner applies it with K4 (``shard_update``).
A lane travels as its packed context words and its counter (plus the
hop's few routing columns): K4 recomputes the centre hash, which costs
less than carrying it.  JAX packs lanes into a fixed (D * cap, 8 + w_k)
slot matrix, with an overflow flag, a discarded attempt and an all-gather
rerun, because XLA needs static shapes.  Here each hop sends
variable-size per-destination blocks (sort by owner, ``bincount``,
``split``, copy), so there is no capacity, no overflow and no fallback.

The all-gather design (JAX ``shard_index :54``, ``make_sharded_call_step
:110``, reached only with ``routed=False``) is not ported (ROADMAP).
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from itertools import compress

import numpy as np
import torch

from ..index.device import (
    RANK_BITS,
    device_map_entries,
    events_ms,
    minifilter_rows,
    pack_bloom_rows,
    packed_steps,
    replay_on_host,
    short_contigs_on_host,
    timing_events,
)
from ..index.kmap_table import BucketTable
from ..ops import kernels
from ..ops.bloom import bloom_set, from_u32, lanes, to_u32
from ..ops.packed import popcount32
from ..ops.xxh3 import check_bloom_size, xxh3_64, xxh3_mod_size
from ..utils.config import Config

TAG = "malva-tpu-torch"


@dataclass
class Shard:
    """One shard's arrays on its mesh device (int32 storage)."""

    device: torch.device
    bf_packed: torch.Tensor   # (W/S, 2): [word, local rank (+ mini-filter in top 4 bits)]
    ctx_words: torch.Tensor   # (W/S,)
    kmap_keys: torch.Tensor   # (nbs, SLOTS * w_k)
    state: torch.Tensor | None  # [bf_counts (cmax) | kmap_vals (nbs * SLOTS)]


@dataclass
class ShardedIndex:
    """The routed sharded index (JAX ``RoutedIndexState``) on a mesh."""

    shards: list
    counts_len: list          # real counter count of each shard (<= cmax)
    cmax: int
    tables: list              # per-shard host BucketTable, for write-back (or None)
    nbs: int                  # buckets per shard
    size_bits: int
    k: int
    ref_k: int
    minifilter: bool = False  # the rows carry the exact-map mini-filter

    @property
    def words_per_shard(self) -> int:
        return self.size_bits // 32 // len(self.shards)

    @classmethod
    def place(cls, arrays: dict, mesh, tables=None) -> "ShardedIndex":
        """Put the numpy arrays of JAX's ``RoutedIndexState`` on the mesh,
        shard s on ``mesh[s]``.  Every tensor is a fresh copy: virtual
        shards of one device alias nothing.  JAX's rows carry no
        mini-filter, so the index has none."""
        S = len(mesh)
        bf_packed = np.asarray(arrays["bf_packed"], dtype=np.uint32)
        counts = np.asarray(arrays["bf_counts"], dtype=np.uint32)
        vals = np.asarray(arrays["kmap_vals"], dtype=np.uint32)
        if bf_packed.shape[0] != S or counts.shape[0] != S or vals.shape[0] != S:
            raise ValueError(f"index arrays hold {bf_packed.shape[0]} shards; the mesh has {S}")
        shards = [Shard(device=d,
                        bf_packed=from_u32(bf_packed[s], d),
                        ctx_words=from_u32(arrays["ctx_words"][s], d),
                        kmap_keys=from_u32(arrays["kmap_keys"][s], d),
                        state=from_u32(np.concatenate([counts[s], vals[s]]), d))
                  for s, d in enumerate(mesh)]
        return cls(shards=shards, counts_len=[int(n) for n in arrays["counts_len"]],
                   cmax=int(counts.shape[1]), tables=tables, nbs=int(arrays["nbs"]),
                   size_bits=int(arrays["size_bits"]), k=int(arrays["k"]),
                   ref_k=int(arrays["ref_k"]))

    def restart(self, index) -> None:
        """Set every shard's counter state from the host counters (at the
        build, and for a reused index, as ``call_batch``'s next sample)."""
        starts = np.concatenate([[0], np.cumsum(self.counts_len)])
        for s, (sh, table) in enumerate(zip(self.shards, self.tables)):
            counts = np.zeros(self.cmax, dtype=np.uint32)
            counts[: self.counts_len[s]] = index.bf.counts[starts[s] : starts[s + 1]]
            table.set_vals_from(index.ref_bf.kmers)
            sh.state = from_u32(np.concatenate([counts, table.vals]), sh.device)

    def write_back(self, index) -> None:
        """Fold every shard's counter state back into the host index
        (JAX ``write_back_routed``)."""
        states = [to_u32(sh.state) for sh in self.shards]
        index.bf.counts = np.concatenate([st[:n] for st, n in zip(states, self.counts_len)])
        for st, table in zip(states, self.tables):
            table.write_back(st[self.cmax :], index.ref_bf.kmers)


def routed_tables(index, cfg: Config, n_shards: int) -> list:
    """The exact map partitioned by the Bloom-word owner of each key, one
    BucketTable per shard, all of the same bucket count: JAX's
    ``shard_index_routed`` (``:259-280``), the "rebuild until every shard
    has the same bucket count" loop included."""
    wps = index.bf.words.shape[0] // n_shards
    keys, rows, _ = device_map_entries(index, cfg)
    owner = ((xxh3_64(rows) % np.uint64(cfg.bf_size)) >> np.uint64(5)).astype(np.int64) // wps
    parts = [(list(compress(keys, owner == s)), rows[owner == s]) for s in range(n_shards)]
    nbs = max([1] + [BucketTable(b, cfg.k, rows=r).n_buckets for b, r in parts])
    while True:  # rebuild until uniform (an overflow can double one shard)
        tables = [BucketTable(b, cfg.k, min_buckets=nbs, rows=r) for b, r in parts]
        grown = max(t.n_buckets for t in tables)
        if grown == nbs:
            return tables
        nbs = grown


def shard_index_routed(index, cfg: Config, mesh) -> ShardedIndex:
    """Split a host index into ``len(mesh)`` hash ranges on the mesh: JAX's
    routed layout.  The bucket tables are built on the host; each shard's
    Bloom and context words are uploaded dense and its [word, local rank]
    rows built on its device, as ``DeviceIndex.from_host`` does, with the
    mini-filter of its own map keys where every shard's counters fit below
    it (2^28)."""
    check_bloom_size(cfg.bf_size)
    S = len(mesh)
    W = index.bf.words.shape[0]
    if W % S:
        raise ValueError(f"{W} Bloom words do not split into {S} shards")
    wps = W // S
    tables = routed_tables(index, cfg, S)
    words = [from_u32(index.bf.words[s * wps : (s + 1) * wps], d) for s, d in enumerate(mesh)]
    counts_len = [int(popcount32(lanes(w)).sum()) for w in words]
    minifilter = max(counts_len) < (1 << RANK_BITS)
    shards = []
    for s, (d, w, table) in enumerate(zip(mesh, words, tables)):
        h = table.key_hashes if minifilter else np.zeros(0, np.uint64)
        mf_rows, mf_bits = (torch.from_numpy(a).to(d) for a in
                            minifilter_rows(h, cfg.bf_size, word_base=s * wps))
        shards.append(Shard(device=d, bf_packed=pack_bloom_rows(w, mf_rows, mf_bits),
                            ctx_words=from_u32(index.context_bf.words[s * wps : (s + 1) * wps], d),
                            kmap_keys=from_u32(table.bucket_keys, d),
                            state=None))
    del words
    sharded = ShardedIndex(shards=shards, counts_len=counts_len, cmax=max([1] + counts_len),
                           tables=tables, nbs=tables[0].n_buckets, size_bits=cfg.bf_size,
                           k=cfg.k, ref_k=cfg.ref_k, minifilter=minifilter)
    sharded.restart(index)
    return sharded


def exchange(mesh, payloads: list, dests: list) -> list:
    """Row i of ``payloads[s]`` goes to shard ``dests[s][i]``.  Each source
    sorts its rows by destination and sends one block to each shard, of
    whatever size: returns, per shard, the rows it received, in source
    order (on its own device)."""
    S = len(mesh)
    blocks: list[list] = [[] for _ in range(S)]
    for payload, dest in zip(payloads, dests):
        order = torch.argsort(dest, stable=True)
        sizes = torch.bincount(dest, minlength=S).tolist()
        for d, part in enumerate(torch.split(payload[order], sizes)):
            blocks[d].append(part.to(mesh[d], non_blocking=True))
    return [torch.cat(b) for b in blocks]


def routed_step(sharded: ShardedIndex, mesh, ctx: list, counters: list, stats: dict,
                events: dict | None = None) -> None:
    """One routed call step.  ``ctx[s]`` (n_s, wc) packed contexts and
    ``counters[s]`` (n_s,) are source shard s's slice of the batch, on
    ``mesh[s]`` (int32 storage).  Updates every shard's state in place and
    adds the rows each shard handled to ``stats["hop1_rows"]`` and
    ``stats["hop2_rows"]``.  With ``events``, the K1 and K4 launches are
    timed by their launchers (lists under "callstep_hash" and
    "shard_update")."""
    k, ref_k, size_bits = sharded.k, sharded.ref_k, sharded.size_bits
    wc = (ref_k + 15) // 16
    wps = sharded.words_per_shard

    def timed(kind: str, device):
        if events is None:
            return None
        ev = timing_events(device)
        events[kind].append(ev)
        return ev

    # source: hash the own slice once (K1 hash-only), route by context word
    pay1, dst1 = [], []
    for s, (c, n) in enumerate(zip(ctx, counters)):
        x_hi, x_lo, c_hi, c_lo = kernels.callstep_hash(c, k, ref_k, with_ctx=True,
                                                       events=timed("callstep_hash", mesh[s]))[:4]
        cw, cb = xxh3_mod_size(x_hi, x_lo, size_bits)
        bw, _ = xxh3_mod_size(c_hi, c_lo, size_bits)
        cols = torch.stack([cw % wps, cb, bw // wps], dim=1).to(torch.int32)
        pay1.append(torch.cat([c, n[:, None], cols], dim=1))
        dst1.append(cw // wps)
    # hop 1: the context-word owner tests its context-filter bit
    pay2, dst2 = [], []
    for d, (sh, got) in enumerate(zip(sharded.shards, exchange(mesh, pay1, dst1))):
        stats["hop1_rows"][d] += got.shape[0]
        lcw, cb = got[:, wc + 1].long(), got[:, wc + 2].long()
        known = (lanes(sh.ctx_words[lcw]) >> cb) & 1
        pay2.append(torch.cat([got[:, : wc + 1], known.to(torch.int32)[:, None]], dim=1))
        dst2.append(got[:, wc + 3].long())
    # hop 2: the Bloom-word owner applies the lane (K4)
    for d, (sh, got) in enumerate(zip(sharded.shards, exchange(mesh, pay2, dst2))):
        stats["hop2_rows"][d] += got.shape[0]
        kernels.shard_update(sh.bf_packed, sh.kmap_keys, sh.state, got[:, :wc].contiguous(),
                             got[:, wc].contiguous(), got[:, wc + 1].bool(), k=k, ref_k=ref_k,
                             size_bits=size_bits, n_buckets=sharded.nbs, word_base=d * wps,
                             counts_len=sharded.cmax, minifilter=sharded.minifilter,
                             events=timed("shard_update", mesh[d]))


class ShardedCallSession:
    """The sharded call phase over many steps (JAX ``:628``): the index is
    sharded once (or a given one restarts from the host counters), each
    :meth:`step` splits a block of packed rows into one contiguous slice
    per shard and runs the routed step, and :meth:`finish` writes the
    counters back and returns the stats."""

    def __init__(self, index, cfg: Config, mesh, sharded: ShardedIndex | None = None):
        t0 = time.perf_counter()
        if sharded is None:
            sharded = shard_index_routed(index, cfg, mesh)
        else:
            sharded.restart(index)
        self.index, self.mesh, self.sharded = index, mesh, sharded
        S = len(mesh)
        self.timed = mesh[0].type == "cuda"
        self.events = {"callstep_hash": [], "shard_update": []} if self.timed else None
        self.stats = {"rows": 0, "steps": 0, "shards": S, "hop1_rows": [0] * S,
                      "hop2_rows": [0] * S, "hash_ms": None, "kernel_ms": None,
                      "upload_s": time.perf_counter() - t0, "writeback_s": None}

    def step(self, packed: np.ndarray, counters: np.ndarray) -> None:
        S = len(self.mesh)
        n = packed.shape[0]
        bounds = [n * s // S for s in range(S + 1)]
        ctx = [from_u32(packed[a:b], d) for a, b, d in zip(bounds, bounds[1:], self.mesh)]
        cnt = [from_u32(counters[a:b], d) for a, b, d in zip(bounds, bounds[1:], self.mesh)]
        routed_step(self.sharded, self.mesh, ctx, cnt, self.stats, self.events)
        self.stats["rows"] += n
        self.stats["steps"] += 1

    def finish(self) -> dict:
        if self.timed:
            self.stats["hash_ms"] = events_ms(self.events["callstep_hash"])
            self.stats["kernel_ms"] = events_ms(self.events["shard_update"])
        t0 = time.perf_counter()
        self.sharded.write_back(self.index)
        self.stats["writeback_s"] = time.perf_counter() - t0
        return self.stats


def apply_sample_counts_sharded_stream(index, batches, cfg: Config, mesh,
                                       batch: int | None = None,
                                       sharded: ShardedIndex | None = None) -> dict:
    """Stream (contexts, counters) batches through the routed step on
    ``mesh`` (JAX ``:719``); the inputs are as the single-device stream
    takes them (``index.device.packed_steps``: 2-bit packed rows stay
    packed, ASCII rows are canonicalized, non-ACGT rows are replayed on the
    host).  ``batch`` rows a step, ``MALVA_SHARD_BATCH`` by default.
    Returns the session's stats."""
    if batch is None:
        batch = int(os.environ.get("MALVA_SHARD_BATCH", 1 << 20))
    sess = ShardedCallSession(index, cfg, mesh, sharded=sharded)
    host_rows: list = []
    for packed, cnts in packed_steps(batches, cfg, batch, host_rows):
        sess.step(packed, cnts)
    stats = sess.finish()
    replay_on_host(index, host_rows, cfg)
    return stats


def apply_sample_counts_sharded(index, contexts: np.ndarray, counters: np.ndarray, cfg: Config,
                                mesh, batch: int = 1 << 20, routed: bool = True) -> dict:
    """Multi-device equivalent of ``malva_tpu.pipeline.apply_sample_counts``."""
    if not routed:
        raise NotImplementedError(
            "the all-gather sharded step (malva_tpu/parallel/sharded_index.py:110 "
            "make_sharded_call_step, routed=False) is not ported; ROADMAP Queue 1 item 16")
    return apply_sample_counts_sharded_stream(index, [(contexts, counters)], cfg, mesh,
                                              batch=batch)


def make_sharded_ref_scan(mesh, k: int, ref_k: int, size_bits: int, slice_chunk: int):
    """The sharded context scan's step (JAX ``:519``):
    ``scan(bf_words, ctx_shards, seqs, start, n_pos, stats)`` scans
    positions ``[start, start + S * slice_chunk)`` of one contig, slice s on
    shard s.  Each shard hashes its slice's windows (K2 hash-only, the
    ref_k - 1 halo read from the contig), probes the alt words
    (``bf_words[device]``, one copy per device), and sends only the hits to
    the owners of their context words, which set the bits."""
    S = len(mesh)
    wps = size_bits // 32 // S

    def scan(bf_words: dict, ctx_shards: list, seqs: dict, start: int, n_pos: int,
             stats: dict) -> None:
        payloads, dests = [], []
        for s, dev in enumerate(mesh):
            p0 = start + s * slice_chunk
            n = min(slice_chunk, n_pos - p0)
            if n <= 0:  # the contig ends before this shard's slice
                break
            c_hi, c_lo, x_hi, x_lo = kernels.window_hash(seqs[dev][p0 : p0 + n + ref_k - 1],
                                                         n, k, ref_k)
            bw, bb = xxh3_mod_size(c_hi, c_lo, size_bits)
            hit = ((lanes(bf_words[dev][bw]) >> bb) & 1).bool()
            cw, cb = xxh3_mod_size(x_hi[hit], x_lo[hit], size_bits)
            payloads.append(torch.stack([cw % wps, cb], dim=1))
            dests.append(cw // wps)
            stats["positions"] += n
        for d, got in enumerate(exchange(mesh, payloads, dests)):
            stats["hits"][d] += got.shape[0]
            bloom_set(ctx_shards[d], got[:, 0], got[:, 1],
                      torch.ones(got.shape[0], dtype=torch.bool, device=got.device))

    return scan


def build_context_sharded(index, refs_used: list[np.ndarray], cfg: Config, mesh,
                          slice_chunk: int = 1 << 20) -> None:
    """The reference context scan over a mesh (JAX ``:582``), updating
    ``index.context_bf.words``; equivalent to the host scan.  Short contigs
    go first, on the host; the words come back sparse."""
    S = len(mesh)
    check_bloom_size(cfg.bf_size)
    W = index.bf.words.shape[0]
    if W % S:
        raise ValueError(f"{W} Bloom words do not split into {S} shards")
    wps = W // S
    short_contigs_on_host(index, refs_used, cfg)

    devices = list(dict.fromkeys(mesh))
    bf_words = {d: from_u32(index.bf.words, d) for d in devices}
    ctx = [from_u32(index.context_bf.words[s * wps : (s + 1) * wps], d)
           for s, d in enumerate(mesh)]
    scan = make_sharded_ref_scan(mesh, cfg.k, cfg.ref_k, cfg.bf_size, slice_chunk)
    stats = {"positions": 0, "hits": [0] * S}
    for ref in refs_used:
        if len(ref) < cfg.ref_k:
            continue
        seq = torch.from_numpy(np.ascontiguousarray(ref, dtype=np.uint8))
        seqs = {d: seq.to(d) for d in devices}
        n_pos = len(ref) - cfg.ref_k + 1
        for start in range(0, n_pos, S * slice_chunk):
            scan(bf_words, ctx, seqs, start, n_pos, stats)
    for s, words in enumerate(ctx):  # the scan only sets bits: nonzero words stay nonzero
        nz = torch.nonzero(words).squeeze(1)
        index.context_bf.words[s * wps + nz.cpu().numpy()] = to_u32(words[nz])
    print(f"[{TAG}] sharded context scan: {stats['positions']} positions over {S} shards "
          f"({', '.join(map(str, mesh))}); hits routed to their context-word owners "
          f"{stats['hits']}", file=sys.stderr)


def log_sharded_step(stats: dict) -> None:
    """One stderr line with the sharded call step's rows, routing and the
    device time of its kernels (launcher events)."""
    print(f"[{TAG}/metrics] sharded call step: {stats['rows']} distinct k-mers in "
          f"{stats['steps']} steps over {stats['shards']} shards; rows per shard, hop 1 "
          f"{stats['hop1_rows']}, hop 2 {stats['hop2_rows']}; device time K1 hash-only "
          f"{stats['hash_ms']} ms, K4 {stats['kernel_ms']} ms (launcher events); index "
          f"upload {stats['upload_s']:.6g} s, write-back {stats['writeback_s']:.6g} s",
          file=sys.stderr)
