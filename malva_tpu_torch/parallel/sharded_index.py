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
the owner of its context word, which tests the context-filter bit; hop 2
sends it on to the owner of its centre's Bloom word, carrying that bit,
and the owner applies it with K4 (``shard_update``).  A lane travels as
its packed context words and its counter (plus the hop's few routing
columns): K4 recomputes the centre hash, which costs less than carrying
it.  As in JAX, each hop packs its lanes into fixed slots, ``cap`` rows
per (source, destination) pair (JAX's capacity rule, :func:`capacity`),
in lane order: K6 (``route_pack``) on each source and K7
(``route_probe``, with the context test) on each hop-1 owner write one
block per destination with its row count in a header, and K4's slot
entry reads the received blocks as they are.  A :class:`Router`, made
once per session, holds every card's blocks; each hop's blocks go card
to card as fixed-size copies, each (source, destination) pair on a copy
stream of its own, ordered by CUDA events (``csrc/route.cu``
``malva_route_copies``), and blocks between shards of one device are
written in place.  The sizes are known when the copies are issued, so a
step reads nothing on the host.  A lane whose rank reaches ``cap`` (JAX
then discards the attempt and reruns the batch through an all-gather) is
appended to an overflow list on its card; the session reads the lists'
sizes once, at its end, and reruns those rows through the routed step
with ``cap`` at their number, which cannot overflow.  That is exact:
each lane's update depends only on its own context and counter and the
read-only index, and counter adds commute.

How the data moves between the host and the cards (:func:`upload`,
:func:`read_host`, :class:`Uploader`): each host array crosses to the
cards once, each shard taking only its slice; a session's steps go
through pinned host buffers, one thread per shard, made once.  An array
that every device needs (the alt words and the contig bytes of the
context scan) crosses to the first card and is copied from there card to
card, with peer access on (:func:`enable_peer`).  The context scan's hits
go to the owners of their context words as the routed step's lanes do:
K8 packs them into fixed slot blocks, the blocks go card to card, and the
owner's K8 launch of the next chunk sets their bits (K9 after the last
chunk) (:class:`ScanRouter`), with no host read until the scan's end.

The all-gather design (JAX ``shard_index :54``, ``write_back :101``,
``make_sharded_call_step :110``), reached only with ``routed=False``
(``ShardedCallSession``, ``apply_sample_counts_sharded``), cuts the Bloom,
rank, counter and context arrays as the routed index does, but keeps ONE
global bucket table (``min_buckets=S``), cut into S contiguous bucket
ranges, and rows without a mini-filter (:class:`GatherIndex`).  Its step
(:func:`gather_step`) copies every source slice to every shard; every
shard hashes the whole batch once (K1 hash-only: the design's O(B) work
per shard) and tests the context words it owns; the flags are OR-merged
across the shards (JAX's ``psum > 0``) and the merged ``known`` goes to
every shard, which applies the whole batch to its ranges with K5
(``gather_update``) from the centre hashes K1 hash-only wrote.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
from ..ops import _build, kernels
from ..ops.bloom import lanes, to_u32
from ..ops.packed import popcount32
from ..ops.xxh3 import check_bloom_size, xxh3_64
from ..ops.xxh3_torch import xxh3_mod_size
from ..utils.config import Config
from .mesh import cards_of

TAG = "malva-tpu-torch"


def upload(arrays: list, devices) -> list:
    """The sharded path's one way from the host to the cards: host array
    ``arrays[i]`` as a tensor on ``devices[i]``, always a copy (uint32 as
    int32 storage, as ``ops.bloom.from_u32``).  To several cards the
    copies go from one thread per array: a copy from pageable memory is
    staged by the host, and the stagings run side by side (1 GiB in four
    slices 2.8x faster than one after another; ``tools/multicard_run.py``,
    PERF.md section 6)."""
    hosts = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:  # torch.from_numpy wants a writable array
            a = a.copy()
        hosts.append(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a))
    if torch.device(devices[0]).type == "cuda" and len(set(devices)) > 1:
        with ThreadPoolExecutor(len(hosts)) as pool:
            return list(pool.map(lambda h, d: h.to(d, copy=True), hosts, devices))
    return [h.to(d, non_blocking=True, copy=True) for h, d in zip(hosts, devices)]


def row_slices(a: np.ndarray, n_shards: int) -> list:
    """``a`` cut by rows into ``n_shards`` equal slices (views)."""
    n = a.shape[0] // n_shards
    return [a[s * n : (s + 1) * n] for s in range(n_shards)]


def replicate(t: torch.Tensor, devices) -> dict:
    """``t`` (on ``devices[0]``) on every device of ``devices``: copied
    card to card, without a host wait; one tensor per device."""
    return {d: t if d == devices[0] else t.to(d, non_blocking=True) for d in devices}


HOST_READS = [0]  # read_host's calls in this process (the context scan logs its chunks')


def read_host(tensors: list) -> list:
    """Equal-shape tensors on the mesh's devices, read to the host at once
    (a list per tensor): they are gathered on the first one's device and
    read there, so the host waits once, for every card."""
    HOST_READS[0] += 1
    first = tensors[0].device
    return torch.stack([t.to(first, non_blocking=True) for t in tensors]).tolist()


def synchronize(devices) -> None:
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


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
        shard s on ``mesh[s]``.  JAX's rows carry no mini-filter, so the
        index has none."""
        shards, cmax = place_shards(arrays, mesh)
        return cls(shards=shards, counts_len=[int(n) for n in arrays["counts_len"]], cmax=cmax,
                   tables=tables, nbs=int(arrays["nbs"]), size_bits=int(arrays["size_bits"]),
                   k=int(arrays["k"]), ref_k=int(arrays["ref_k"]))

    def restart(self, index) -> None:
        """Set every shard's counter state from the host counters (at the
        build, and for a reused index, as ``call_batch``'s next sample)."""
        states = []
        for counts, table in zip(shard_counts(index, self.counts_len, self.cmax), self.tables):
            table.set_vals_from(index.ref_bf.kmers)
            states.append(np.concatenate([counts, table.vals]))
        for sh, state in zip(self.shards, upload(states, [sh.device for sh in self.shards])):
            sh.state = state

    def write_back(self, index) -> None:
        """Fold every shard's counter state back into the host index
        (JAX ``write_back_routed``)."""
        states = [to_u32(sh.state) for sh in self.shards]
        index.bf.counts = np.concatenate([st[:n] for st, n in zip(states, self.counts_len)])
        for st, table in zip(states, self.tables):
            table.write_back(st[self.cmax :], index.ref_bf.kmers)


def place_shards(arrays: dict, mesh) -> tuple[list, int]:
    """Shard s of JAX's (S, ...) index arrays on ``mesh[s]``, and the
    padded counter length.  Every tensor is a fresh copy: virtual shards
    of one device alias nothing."""
    S = len(mesh)
    bf_packed, counts, keys, vals = (np.asarray(arrays[n], dtype=np.uint32) for n in
                                     ("bf_packed", "bf_counts", "kmap_keys", "kmap_vals"))
    if any(a.shape[0] != S for a in (bf_packed, counts, keys, vals)):
        raise ValueError(f"index arrays hold {bf_packed.shape[0]} shards; the mesh has {S}")
    shards = [Shard(device=d, bf_packed=bp, ctx_words=cw, kmap_keys=kk, state=st)
              for d, bp, cw, kk, st in zip(
                  mesh, upload(list(bf_packed), mesh), upload(list(arrays["ctx_words"]), mesh),
                  upload(list(keys), mesh),
                  upload([np.concatenate([c, v]) for c, v in zip(counts, vals)], mesh))]
    return shards, int(counts.shape[1])


def shard_counts(index, counts_len: list, cmax: int) -> list:
    """Each shard's slice of the host counters, padded to ``cmax``."""
    starts = np.concatenate([[0], np.cumsum(counts_len)]).astype(np.int64)
    out = []
    for s, n in enumerate(counts_len):
        counts = np.zeros(cmax, dtype=np.uint32)
        counts[:n] = index.bf.counts[starts[s] : starts[s + 1]]
        out.append(counts)
    return out


@dataclass
class GatherIndex:
    """The all-gather sharded index (JAX ``ShardedIndexState``) on a mesh:
    shard s holds Bloom words ``[s * W/S, (s + 1) * W/S)`` as [word, local
    rank] rows (no mini-filter), the same range of context words, its
    counters (padded to the longest shard) and buckets ``[s * nbps, (s + 1)
    * nbps)`` of one global bucket table of ``n_buckets``; its state is
    ``[bf_counts (cmax) | kmap_vals (nbps * SLOTS)]``."""

    shards: list
    counts_len: list
    cmax: int
    table: object | None      # the global host BucketTable, for write-back (or None)
    n_buckets: int            # global bucket count, a multiple of the shard count
    size_bits: int
    k: int
    ref_k: int

    @property
    def words_per_shard(self) -> int:
        return self.size_bits // 32 // len(self.shards)

    @property
    def buckets_per_shard(self) -> int:
        return self.n_buckets // len(self.shards)

    @classmethod
    def place(cls, arrays: dict, mesh, table=None) -> "GatherIndex":
        """Put the numpy arrays of JAX's ``ShardedIndexState`` on the mesh,
        shard s on ``mesh[s]``."""
        shards, cmax = place_shards(arrays, mesh)
        nbps = shards[0].kmap_keys.shape[0]
        if int(arrays["n_buckets"]) != len(mesh) * nbps:
            raise ValueError(f"{len(mesh)} shards of {nbps} buckets are not n_buckets="
                             f"{int(arrays['n_buckets'])}")
        return cls(shards=shards, counts_len=[int(n) for n in arrays["counts_len"]], cmax=cmax,
                   table=table, n_buckets=int(arrays["n_buckets"]),
                   size_bits=int(arrays["size_bits"]), k=int(arrays["k"]),
                   ref_k=int(arrays["ref_k"]))

    def host_table(self):
        """The global host BucketTable that maps the shards' slots to the
        host's k-mers; an index placed without one cannot restart or write
        back."""
        if self.table is None:
            raise ValueError("this GatherIndex was placed without its host BucketTable "
                             "(table=None), so it cannot restart from or write back to a "
                             "host index")
        return self.table

    def restart(self, index) -> None:
        """Set every shard's counter state from the host counters."""
        table = self.host_table()
        table.set_vals_from(index.ref_bf.kmers)
        states = [np.concatenate([counts, vals]) for counts, vals in
                  zip(shard_counts(index, self.counts_len, self.cmax),
                      row_slices(table.vals, len(self.shards)))]
        for sh, state in zip(self.shards, upload(states, [sh.device for sh in self.shards])):
            sh.state = state

    def write_back(self, index) -> None:
        """Fold every shard's counter state back into the host index (JAX
        ``write_back :101``)."""
        table = self.host_table()
        states = [to_u32(sh.state) for sh in self.shards]
        index.bf.counts = np.concatenate([st[:n] for st, n in zip(states, self.counts_len)])
        table.write_back(np.concatenate([st[self.cmax :] for st in states]), index.ref_bf.kmers)


def word_slices(index, mesh) -> tuple[list, list, list]:
    """Every shard's slice of the Bloom and context words on its device
    (each array crosses once), and the shards' counter counts, read to the
    host once: (words, ctx_words, counts_len)."""
    S = len(mesh)
    if index.bf.words.shape[0] % S:
        raise ValueError(f"{index.bf.words.shape[0]} Bloom words do not split into {S} shards")
    words = upload(row_slices(index.bf.words, S), mesh)
    ctx_words = upload(row_slices(index.context_bf.words, S), mesh)
    counts_len = read_host([popcount32(lanes(w)).sum() for w in words])
    return words, ctx_words, counts_len


def shard_index(index, cfg: Config, mesh) -> GatherIndex:
    """Split a host index into ``len(mesh)`` hash ranges on the mesh: JAX's
    all-gather layout (``shard_index :54``).  The exact map is one bucket
    table of at least S buckets (both powers of two), cut into contiguous
    bucket ranges; each shard's Bloom and context words are uploaded dense
    and its [word, local rank] rows built on its device, without a
    mini-filter."""
    check_bloom_size(cfg.bf_size)
    S = len(mesh)
    keys, rows, _ = device_map_entries(index, cfg)
    table = BucketTable(keys, cfg.k, min_buckets=S, rows=rows)
    words, ctx_words, counts_len = word_slices(index, mesh)
    kmap_keys = upload(row_slices(table.bucket_keys, S), mesh)
    shards = []
    for d, w, cw, kk in zip(mesh, words, ctx_words, kmap_keys):
        none = torch.zeros(0, dtype=torch.int64, device=d)
        shards.append(Shard(device=d, bf_packed=pack_bloom_rows(w, none, none), ctx_words=cw,
                            kmap_keys=kk, state=None))
    del words
    gathered = GatherIndex(shards=shards, counts_len=counts_len, cmax=max([1] + counts_len),
                           table=table, n_buckets=table.n_buckets, size_bits=cfg.bf_size,
                           k=cfg.k, ref_k=cfg.ref_k)
    gathered.restart(index)
    return gathered


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
    words, ctx_words, counts_len = word_slices(index, mesh)
    tables = routed_tables(index, cfg, S)
    kmap_keys = upload([t.bucket_keys for t in tables], mesh)
    minifilter = max(counts_len) < (1 << RANK_BITS)
    wps = index.bf.words.shape[0] // S
    mf = [minifilter_rows(t.key_hashes if minifilter else np.zeros(0, np.uint64), cfg.bf_size,
                          word_base=s * wps) for s, t in enumerate(tables)]
    mf_rows, mf_bits = (upload(list(a), mesh) for a in zip(*mf))
    shards = [Shard(device=d, bf_packed=pack_bloom_rows(w, r, b), ctx_words=cw, kmap_keys=kk,
                    state=None)
              for d, w, cw, kk, r, b in zip(mesh, words, ctx_words, kmap_keys, mf_rows, mf_bits)]
    del words
    sharded = ShardedIndex(shards=shards, counts_len=counts_len, cmax=max([1] + counts_len),
                           tables=tables, nbs=tables[0].n_buckets, size_bits=cfg.bf_size,
                           k=cfg.k, ref_k=cfg.ref_k, minifilter=minifilter)
    sharded.restart(index)
    return sharded


def row_stats(routed: bool, n_shards: int) -> dict:
    """The counters a step adds to: the routed step's rows after each hop
    per shard (summed from the blocks' headers at the end), its host reads,
    the rows its overflow lists held and the bytes of slot blocks copied
    card to card; or the rows each shard received in the all-gather."""
    if routed:
        return {"hop1_rows": [0] * n_shards, "hop2_rows": [0] * n_shards, "host_reads": 0,
                "overflow_rows": 0, "slot_bytes": 0}
    return {"gathered_rows": [0] * n_shards}


def step_events(events: dict | None, kind: str, device):
    """A new pair of launcher events for a ``kind`` launch on ``device``,
    kept in ``events[kind]``; None where the step is not timed."""
    if events is None:
        return None
    ev = timing_events(device)
    events[kind].append(ev)
    return ev


def _add(stats: dict, key: str, value) -> None:
    stats[key] = stats.get(key, 0) + value


def capacity(slice_rows: int, n_shards: int) -> int:
    """Slot rows per (source, destination) pair for source slices of
    ``slice_rows``: twice the uniform mean, at least 128 (JAX
    ``make_routed_call_step``)."""
    return max(128, -(-2 * slice_rows // n_shards))


_PEERS: set = set()  # ordered (card, card) index pairs whose peer access is on


def enable_peer(cards) -> None:
    """Peer access for every ordered pair of distinct CUDA cards in
    ``cards`` (``csrc/route.cu malva_enable_peer``), once per pair in a
    process, so that their copies go card to card without the CUDA
    driver staging them through the host.  The one place the port enables it: the
    context scan before it copies the alt words and the contigs between
    cards, and the routed step's router before its slot copies."""
    idx = [d.index for d in map(torch.device, cards) if d.type == "cuda"]
    pairs = [(a, b) for a in dict.fromkeys(idx) for b in dict.fromkeys(idx)
             if a != b and (a, b) not in _PEERS]
    if not pairs:
        return
    lib = _build.library()
    for a, b in pairs:
        err = lib.malva_enable_peer(a, b)
        if err != 0:
            raise RuntimeError(f"malva_enable_peer(cuda:{a}, cuda:{b}): CUDA error {err}")
        _PEERS.add((a, b))


def copy_plan(mesh, pairs: list, hops: list, keep: list) -> dict:
    """The ctypes arguments of slot-block copies between cards
    (``csrc/route.cu malva_route_copies``) for ``kernels.route_step`` and
    ``kernels.scan_step``, with peer access on for the mesh's cards
    (:func:`enable_peer`).  ``pairs`` are the (source, destination) shards
    on two devices, each with a copy stream of its own; ``hops`` are
    (recv, send, words) per hop: shard d receives source s's block at
    ``recv[d][s * words:]``, sent from ``send[s][d * words:]``.  Per hop:
    the events each shard's compute stream records when its blocks are
    written ("produced") and each copy's ("copied"); "done", one event per
    shard, recorded here once, for the scan (its guards).  The torch
    streams and events the handles belong to go into ``keep``."""
    enable_peer(mesh)

    def arr(kind, values):
        return (kind * len(values))(*values)

    def events(devices, streams=None):
        out = []
        for i, dev in enumerate(devices):
            ev = torch.cuda.Event()
            ev.record(streams[i] if streams else torch.cuda.current_stream(dev))
            keep.append(ev)
            out.append(ev.cuda_event)
        return arr(ctypes.c_void_p, out)

    streams = [torch.cuda.Stream(device=mesh[s]) for s, _ in pairs]
    keep += streams
    plan = {"dev": arr(ctypes.c_int, [d.index for d in mesh]), "n": len(pairs),
            "from": arr(ctypes.c_int, [s for s, _ in pairs]),
            "to": arr(ctypes.c_int, [d for _, d in pairs]),
            "streams": arr(ctypes.c_void_p, [st.cuda_stream for st in streams]), "hops": []}
    for recv, send, w in hops:
        plan["hops"].append({
            "produced": events(mesh), "done": events(mesh),
            "copied": events([mesh[s] for s, _ in pairs], streams),
            "dst": arr(ctypes.c_void_p, [recv[d][s * w:].data_ptr() for s, d in pairs]),
            "src": arr(ctypes.c_void_p, [send[s][d * w:].data_ptr() for s, d in pairs]),
            "bytes": 4 * w})
    return plan


OVERFLOW_STEPS = 16  # the overflow lists hold the most that this many steps can spill


class Router:
    """The routed step's buffers on the mesh, made once per session: on
    each shard's device, the D hop-1 and D hop-2 slot blocks it receives
    (one per source) and, where a destination lies on another device, the
    blocks it sends there; its overflow list, its tally and K6's and K7's
    scratch; a copy stream for each (source, destination) pair of
    two devices and the events that order the copies.

    The overflow lists hold ``OVERFLOW_STEPS`` times the most a step can
    spill on a card (its slice past ``cap`` in hop 1, what it receives past
    ``cap`` in hop 2).  The host keeps that bound; only a session long
    enough to reach it drains the lists before a step (one host read).
    :meth:`drain` reads the tallies once and reruns the spilled rows."""

    def __init__(self, sharded: "ShardedIndex", mesh, slice_rows: int, cap: int | None = None):
        self.sharded, self.mesh = sharded, tuple(mesh)
        D = self.D = len(self.mesh)
        wc = self.wc = (sharded.ref_k + 15) // 16
        self.slice_rows = slice_rows
        self.cap = cap = capacity(slice_rows, D) if cap is None else cap
        self.cuda = self.mesh[0].type == "cuda"
        if self.cuda and max(slice_rows, D * cap) > kernels.ROUTE_MAX_LANES:
            raise ValueError(f"a routed step takes at most {kernels.ROUTE_MAX_LANES} rows a "
                             f"source slice and received a shard; got slices of {slice_rows} "
                             f"rows and {D} x {cap} slots (a smaller MALVA_SHARD_BATCH)")
        worst = self.spill_bound([slice_rows] * D)
        self.ovf_cap = max(1, OVERFLOW_STEPS * max(worst))
        self.bound = [0] * D
        self.words = (kernels.slot_words(cap, wc, kernels.HOP1_COLS),
                      kernels.slot_words(cap, wc, kernels.HOP2_COLS))
        cross = [[a != b for b in self.mesh] for a in self.mesh]
        self.pairs = [(s, d) for s in range(D) for d in range(D) if cross[s][d]]

        def zeros(n, dev, dtype=torch.int32):
            return torch.zeros(n, dtype=dtype, device=dev)

        self.recv, self.out, send = [], [], []
        for w in self.words:
            recv = [zeros(D * w, dev) for dev in self.mesh]
            sent = [zeros(D * w, dev) if any(cross[s]) else None for s, dev in enumerate(self.mesh)]
            self.recv.append(recv)
            send.append(sent)
            self.out.append([[sent[s][d * w : (d + 1) * w] if cross[s][d]
                              else recv[d][s * w : (s + 1) * w] for d in range(D)]
                             for s in range(D)])
        self.overflow = [zeros(self.ovf_cap * (wc + 1), dev) for dev in self.mesh]
        self.tally = [zeros(1 + 2 * D, dev, torch.int64) for dev in self.mesh]
        self.scratch = ([kernels.route_scratch(dev, D) for dev in self.mesh] if self.cuda
                        else [None] * D)
        self.slot_bytes = 4 * sum(self.words) * len(self.pairs)  # a step's copies
        self.send = send
        self.copies = self._copy_plan() if self.pairs and self.cuda else None
        self.plan = self._step_plan() if self.cuda else None

    def spill_bound(self, rows: list) -> list:
        """The most rows each card's overflow list can gain in a step over
        source slices of ``rows``: its slice past ``cap`` (hop 1) and what
        it receives past ``cap`` (hop 2: at most ``cap`` from each source
        and the step's rows in all)."""
        got = min(self.D * self.cap, sum(rows))
        return [max(0, n - self.cap) + max(0, got - self.cap) for n in rows]

    def _copy_plan(self) -> dict:
        """The ctypes arguments of both hops' copies for ``kernels.route_step``
        (:func:`copy_plan`)."""
        self._keep = []
        return copy_plan(self.mesh, self.pairs,
                         [(self.recv[h], self.send[h], w) for h, w in enumerate(self.words)],
                         self._keep)

    def _step_plan(self) -> np.ndarray:
        """The step's plan for ``kernels.route_step``: each shard's device,
        buffers and index arrays (columns from ``kernels.route_layout``);
        the slice, stream and events go in at each step.  K1's hash words go
        to a buffer of the router's slices."""
        sh, P = self.sharded, kernels.route_layout()[1]
        if self.D > P["max_dests"]:
            raise ValueError(f"the routed step takes at most {P['max_dests']} shards, got "
                             f"{self.D}")
        w_k = (sh.k + 15) // 16
        self.hx = [torch.empty((4 + w_k) * self.slice_rows, dtype=torch.int32, device=dev)
                   for dev in self.mesh]
        plan = np.zeros((self.D, P["width"]), dtype=np.int64)
        for s, (dev, shard) in enumerate(zip(self.mesh, sh.shards)):
            for t, name in ((shard.bf_packed, "bf_packed"), (shard.kmap_keys, "kmap_keys"),
                            (shard.state, "state"), (shard.ctx_words, "ctx_words")):
                kernels._check(t, torch.int32, name)
                if t.device != dev:
                    raise ValueError(f"shard {s}'s {name} lies on {t.device}, not {dev}")
            row = plan[s]
            row[P["dev"]], row[P["ovf_cap"]] = dev.index, self.ovf_cap
            row[P["n_words"]] = shard.bf_packed.shape[0]
            for name, t in (("hx", self.hx[s]), ("recv1", self.recv[0][s]),
                            ("recv2", self.recv[1][s]), ("ovf", self.overflow[s]),
                            ("tally", self.tally[s]), ("counts", self.scratch[s]),
                            ("ctx_words", shard.ctx_words), ("bf_packed", shard.bf_packed),
                            ("kmap_keys", shard.kmap_keys), ("state", shard.state)):
                row[P[name]] = t.data_ptr()
            for hop, col in enumerate(("out1", "out2")):
                row[P[col] : P[col] + self.D] = [b.data_ptr() for b in self.out[hop][s]]
        return plan

    def _exchange(self, hop: int) -> None:
        """Off CUDA, hop ``hop``'s blocks to their destinations on other
        devices, by tensor copies (on CUDA the step's C call copies)."""
        w = self.words[hop]
        for s, d in self.pairs:
            self.recv[hop][d][s * w : (s + 1) * w].copy_(self.send[hop][s][d * w : (d + 1) * w])

    def _step_cuda(self, ctx: list, counters: list, events: dict | None) -> None:
        """The step on CUDA: this step's slices, streams and launcher
        events into the plan, then one ``kernels.route_step``."""
        sh, P, plan = self.sharded, kernels.route_layout()[1], self.plan
        for s, (dev, c, n) in enumerate(zip(self.mesh, ctx, counters)):
            kernels._check(c, torch.int32, "ctx")
            kernels._check(n, torch.int32, "counters")
            if c.device != dev or n.device != dev or c.shape != (n.shape[0], self.wc):
                raise ValueError(f"source slice {s}: ({n.shape[0]}, {self.wc}) int32 contexts "
                                 f"and counters on {dev}, got {tuple(c.shape)} on {c.device}")
            stream = torch.cuda.current_stream(dev)
            plan[s, P["ctx"]], plan[s, P["counters"]] = c.data_ptr(), n.data_ptr()
            plan[s, P["rows"]], plan[s, P["stream"]] = c.shape[0], stream.cuda_stream
            for col, kind in (("ev_hash0", "callstep_hash"), ("ev_upd0", "shard_update")):
                ev = step_events(events, kind, dev)
                if ev is not None:
                    for e in ev:  # a torch event makes its CUDA event at its first record
                        e.record(stream)
                plan[s, P[col] : P[col] + 2] = [e.cuda_event for e in ev] if ev else 0
        kernels.route_step(plan, wc=self.wc, k=sh.k, ref_k=sh.ref_k, size_bits=sh.size_bits,
                           wps=sh.words_per_shard, cap=self.cap, n_buckets=sh.nbs,
                           counts_len=sh.cmax, minifilter=sh.minifilter, copies=self.copies)

    def step(self, ctx: list, counters: list, stats: dict, events: dict | None = None) -> None:
        """One routed step over source slices ``ctx[s]`` (n_s, wc) and
        ``counters[s]`` (n_s,) on ``mesh[s]``: K1 hash-only and K6 on each
        source, hop 1's copies, K7 on each owner, hop 2's copies and K4's
        slot entry on each owner; on CUDA all of it in one C call
        (:meth:`_step_cuda`), elsewhere through each kernel's wrapper (the
        plain versions).  No host read, unless the overflow lists could
        fill in this step (then :meth:`drain` first)."""
        sh, D, cap, wc = self.sharded, self.D, self.cap, self.wc
        rows = [c.shape[0] for c in ctx]
        if max(rows) > self.slice_rows:
            raise ValueError(f"a source slice of {max(rows)} rows; the router holds "
                             f"{self.slice_rows}")
        more = self.spill_bound(rows)
        if any(b + m > self.ovf_cap for b, m in zip(self.bound, more)):
            self.drain(stats)
        self.bound = [b + m for b, m in zip(self.bound, more)]
        _add(stats, "slot_bytes", self.slot_bytes)
        if self.plan is not None:
            return self._step_cuda(ctx, counters, events)
        k, ref_k, size_bits, wps = sh.k, sh.ref_k, sh.size_bits, sh.words_per_shard
        for s, (c, n) in enumerate(zip(ctx, counters)):
            hx = kernels.callstep_hash_words(c, k, ref_k, with_ctx=True,
                                             events=step_events(events, "callstep_hash",
                                                                self.mesh[s]))
            kernels.route_pack(hx, c, n, self.out[0][s], self.overflow[s], self.tally[s],
                               size_bits=size_bits, wps=wps, cap=cap, scratch=self.scratch[s])
        self._exchange(0)
        for d, shard in enumerate(sh.shards):
            kernels.route_probe(self.recv[0][d], shard.ctx_words, self.out[1][d],
                                self.overflow[d], self.tally[d], wc=wc, cap_in=cap, cap=cap,
                                scratch=self.scratch[d])
        self._exchange(1)
        for d, shard in enumerate(sh.shards):
            kernels.shard_update_slots(shard.bf_packed, shard.kmap_keys, shard.state,
                                       self.recv[1][d], n_blocks=D, cap=cap, k=k, ref_k=ref_k,
                                       size_bits=size_bits, n_buckets=sh.nbs, word_base=d * wps,
                                       counts_len=sh.cmax, minifilter=sh.minifilter,
                                       events=step_events(events, "shard_update", self.mesh[d]))

    def drain(self, stats: dict) -> None:
        """Read every card's tally once: add the rows each shard received
        in each hop to ``stats``, then rerun the rows the overflow lists
        hold through a routed step whose capacity is their number (so
        nothing spills again), and empty the lists."""
        D, wc = self.D, self.wc
        tallies = read_host(self.tally)
        _add(stats, "host_reads", 1)
        for t in self.tally:
            t.zero_()
        self.bound = [0] * D
        for key, at in (("hop1_rows", 1), ("hop2_rows", 1 + D)):
            stats.setdefault(key, [0] * D)
            for d in range(D):
                stats[key][d] += sum(t[at + d] for t in tallies)
        spilled = [t[0] for t in tallies]
        if max(spilled) > self.ovf_cap:
            raise RuntimeError(f"the routed step's overflow lists took {max(spilled)} rows; "
                               f"they hold {self.ovf_cap}")
        total = sum(spilled)
        if total == 0:
            return
        _add(stats, "overflow_rows", total)
        oc = self.ovf_cap
        ctx = [o[: oc * wc].view(oc, wc)[:n] for o, n in zip(self.overflow, spilled)]
        cnt = [o[oc * wc : oc * wc + n] for o, n in zip(self.overflow, spilled)]
        rerun = Router(self.sharded, self.mesh, max(spilled), cap=total)
        rerun.step(ctx, cnt, stats)
        rerun.drain(stats)


class Uploader:
    """A session's way from the host to the shards' devices: each step's
    slice of shard s is copied into one of two pinned host buffers (in
    turn) by the session's thread for that shard, and from there into the
    shard's device buffer of the same turn on an upload stream of its own;
    the shard's compute stream waits for that copy, and a buffer is written
    again only after the step that read it (events, no host read).  The
    threads and buffers are made once, for slices of up to ``rows`` rows.
    Off CUDA, each slice is copied into a fresh tensor."""

    def __init__(self, mesh, rows: int, wc: int):
        self.mesh, self.rows, self.turn = tuple(mesh), rows, 0
        self.cuda = self.mesh[0].type == "cuda"
        if not self.cuda:
            return
        D = len(self.mesh)
        self.pool = ThreadPoolExecutor(D, thread_name_prefix="malva-upload")

        def pair(shape, **kw):
            return [torch.empty(shape, dtype=torch.int32, **kw) for _ in range(2)]

        self.pinned = [(pair((rows, wc), pin_memory=True), pair((rows,), pin_memory=True))
                       for _ in range(D)]
        self.device = [(pair((rows, wc), device=d), pair((rows,), device=d)) for d in self.mesh]
        self.streams = [torch.cuda.Stream(device=d) for d in self.mesh]
        self.uploaded = [[torch.cuda.Event() for _ in range(2)] for _ in range(D)]
        self.used = [[torch.cuda.Event() for _ in range(2)] for _ in range(D)]

    def put(self, packed: np.ndarray, counters: np.ndarray, bounds: list) -> tuple[list, list]:
        """Shard s's slice, rows ``bounds[s]:bounds[s + 1]`` of the host
        arrays, on its device: (contexts, counters)."""
        parts = [(packed[a:b], counters[a:b]) for a, b in zip(bounds, bounds[1:])]
        if not self.cuda:
            return (upload([p for p, _ in parts], self.mesh),
                    upload([c for _, c in parts], self.mesh))
        b = self.turn
        got = list(self.pool.map(lambda s: self._put(s, b, *parts[s]), range(len(self.mesh))))
        for dev, ev in zip(self.mesh, (u[b] for u in self.uploaded)):
            torch.cuda.current_stream(dev).wait_event(ev)
        return [g[0] for g in got], [g[1] for g in got]

    def _put(self, s: int, b: int, ctx: np.ndarray, cnt: np.ndarray):
        n = ctx.shape[0]
        if n > self.rows:
            raise ValueError(f"a slice of {n} rows; the session's buffers hold {self.rows}")
        (pc, pn), (dc, dn) = self.pinned[s], self.device[s]
        self.uploaded[s][b].synchronize()  # the pinned buffer's last copy (two steps ago) is out
        pc[b][:n].numpy()[...] = ctx.view(np.int32)
        pn[b][:n].numpy()[...] = cnt.view(np.int32)
        stream = self.streams[s]
        with torch.cuda.stream(stream):
            stream.wait_event(self.used[s][b])
            dc[b][:n].copy_(pc[b][:n], non_blocking=True)
            dn[b][:n].copy_(pn[b][:n], non_blocking=True)
            self.uploaded[s][b].record(stream)
        return dc[b][:n], dn[b][:n]

    def done(self) -> None:
        """The step that read this turn's buffers is issued."""
        if self.cuda:
            for dev, ev in zip(self.mesh, (u[self.turn] for u in self.used)):
                ev.record(torch.cuda.current_stream(dev))
            self.turn ^= 1

    def close(self) -> None:
        if self.cuda:
            self.pool.shutdown()


def routed_step(sharded: ShardedIndex, mesh, ctx: list, counters: list, stats: dict,
                events: dict | None = None, router: Router | None = None) -> None:
    """One routed call step.  ``ctx[s]`` (n_s, wc) packed contexts and
    ``counters[s]`` (n_s,) are source shard s's slice of the batch, on
    ``mesh[s]`` (int32 storage).  Updates every shard's state in place.
    With a session's ``router`` the step reads nothing on the host, and
    ``router.drain`` adds the rows each shard handled (``hop1_rows``,
    ``hop2_rows``) to the stats at the end; without one, a router is made
    for this step and drained after it (one host read).  With ``events``,
    the K1 and K4 launches are timed by their launchers (lists under
    "callstep_hash" and "shard_update")."""
    own = router is None
    if own:
        router = Router(sharded, mesh, max(c.shape[0] for c in ctx))
    router.step(ctx, counters, stats, events)
    if own:
        router.drain(stats)


def gather_step(gathered: GatherIndex, mesh, ctx: list, counters: list, stats: dict,
                events: dict | None = None) -> None:
    """One all-gather call step (JAX ``make_sharded_call_step :110``).
    ``ctx[s]`` (n_s, wc) packed contexts and ``counters[s]`` (n_s,) are
    source shard s's slice of the batch, on ``mesh[s]`` (int32 storage).
    Updates every shard's state in place and adds the rows each shard
    received to ``stats["gathered_rows"]``.  Every copy, launch and the
    OR-merge of the flags is issued without a host wait.  With ``events``,
    the K1 and K5 launches are timed by their launchers (lists under
    "callstep_hash" and "gather_update")."""
    k, ref_k, size_bits = gathered.k, gathered.ref_k, gathered.size_bits
    wps, nbps = gathered.words_per_shard, gathered.buckets_per_shard

    # the all-gather: every shard gets a copy of every source slice
    full_ctx = [torch.cat([c.to(d, non_blocking=True) for c in ctx]) for d in mesh]
    full_cnt = [torch.cat([n.to(d, non_blocking=True) for n in counters]) for d in mesh]
    # every shard hashes the whole batch once (K1 hash-only: the context
    # hash, the centre hash and the canonical centre) and tests the context
    # words it owns; the flags are OR-merged across the shards
    known, hx = None, []
    for d, (sh, c) in enumerate(zip(gathered.shards, full_ctx)):
        ev = step_events(events, "callstep_hash", mesh[d])
        hx.append(kernels.callstep_hash_words(c, k, ref_k, True, events=ev))
        cw, cb = xxh3_mod_size(lanes(hx[d][0]), lanes(hx[d][1]), size_bits)
        lcw = cw - d * wps
        mine = (lcw >= 0) & (lcw < wps)
        hit = mine & ((lanes(sh.ctx_words[torch.where(mine, lcw, 0)]) >> cb) & 1).bool()
        known = hit.to(mesh[0]) if known is None else known | hit.to(mesh[0])
    # every shard applies the whole batch to its ranges, from its centre
    # planes (K5)
    for d, (sh, h, n) in enumerate(zip(gathered.shards, hx, full_cnt)):
        stats["gathered_rows"][d] += n.shape[0]
        kernels.gather_update(sh.bf_packed, sh.kmap_keys, sh.state, h[2:], n, known.to(mesh[d]),
                              k=k, size_bits=size_bits, n_buckets=gathered.n_buckets,
                              word_base=d * wps, bucket_base=d * nbps, counts_len=gathered.cmax,
                              events=step_events(events, "gather_update", mesh[d]))


class ShardedCallSession:
    """The sharded call phase over many steps (JAX ``:628``): the index is
    sharded once (or a given one restarts from the host counters), each
    :meth:`step` cuts a block of packed rows into steps of at most
    ``batch`` rows (``MALVA_SHARD_BATCH`` by default), each split into one
    contiguous slice per shard and uploaded (:class:`Uploader`), and runs
    the routed step (or, with ``routed=False``, the all-gather step), and
    :meth:`finish` drains the routed step's overflow lists (the session's
    one host read), writes the counters back and returns the stats."""

    def __init__(self, index, cfg: Config, mesh, sharded: ShardedIndex | GatherIndex | None = None,
                 routed: bool = True, batch: int | None = None):
        t0 = time.perf_counter()
        if sharded is None:
            sharded = (shard_index_routed if routed else shard_index)(index, cfg, mesh)
        elif isinstance(sharded, ShardedIndex) != routed:
            raise ValueError(f"a {type(sharded).__name__} cannot run the "
                             f"{'routed' if routed else 'all-gather'} step")
        else:
            sharded.restart(index)
        self.index, self.mesh, self.sharded, self.routed = index, mesh, sharded, routed
        S = len(mesh)
        self.batch = batch or int(os.environ.get("MALVA_SHARD_BATCH", 1 << 20))
        slice_rows = -(-self.batch // S)
        self.router = Router(sharded, mesh, slice_rows) if routed else None
        self.uploader = Uploader(mesh, slice_rows, (cfg.ref_k + 15) // 16)
        self.kernel = "shard_update" if routed else "gather_update"
        self.timed = mesh[0].type == "cuda"
        self.events = {"callstep_hash": [], self.kernel: []} if self.timed else None
        self.stats = {"rows": 0, "steps": 0, "shards": S,
                      "design": "routed" if routed else "gather", **row_stats(routed, S),
                      "hash_ms": None, "kernel_ms": None,
                      "upload_s": time.perf_counter() - t0, "writeback_s": None}
        if routed:
            self.stats["slot_rows"] = self.router.cap

    def step(self, packed: np.ndarray, counters: np.ndarray) -> None:
        S = len(self.mesh)
        for at in range(0, max(packed.shape[0], 1), self.batch):
            rows, cnts = packed[at : at + self.batch], counters[at : at + self.batch]
            n = rows.shape[0]
            ctx, cnt = self.uploader.put(rows, cnts, [n * s // S for s in range(S + 1)])
            if self.routed:
                self.router.step(ctx, cnt, self.stats, self.events)
            else:
                gather_step(self.sharded, self.mesh, ctx, cnt, self.stats, self.events)
            self.uploader.done()
            self.stats["rows"] += n
            self.stats["steps"] += 1

    def finish(self) -> dict:
        if self.routed:
            self.router.drain(self.stats)
        self.uploader.close()
        if self.timed:
            self.stats["hash_ms"] = events_ms(self.events["callstep_hash"])
            self.stats["kernel_ms"] = events_ms(self.events[self.kernel])
        t0 = time.perf_counter()
        self.sharded.write_back(self.index)
        self.stats["writeback_s"] = time.perf_counter() - t0
        self.router = self.uploader = None
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
    return run_session(ShardedCallSession(index, cfg, mesh, sharded=sharded, batch=batch),
                       batches, cfg, batch)


def run_session(sess: ShardedCallSession, batches, cfg: Config, batch: int) -> dict:
    """Step ``sess`` over the batches re-cut into blocks of ``batch`` rows,
    finish it, and replay the rows set aside on the host; its stats."""
    host_rows: list = []
    for packed, cnts in packed_steps(batches, cfg, batch, host_rows):
        sess.step(packed, cnts)
    stats = sess.finish()
    replay_on_host(sess.index, host_rows, cfg)
    return stats


def apply_sample_counts_sharded(index, contexts: np.ndarray, counters: np.ndarray, cfg: Config,
                                mesh, batch: int = 1 << 20, routed: bool = True) -> dict:
    """Multi-device equivalent of ``malva_tpu.pipeline.apply_sample_counts``
    (JAX ``:705``): the routed step, or the all-gather step where
    ``routed=False``, ``batch`` rows a step (no more than the rows given,
    as JAX sizes its slice to the problem).  Returns the session's stats."""
    batch = max(1, min(batch, contexts.shape[0]))
    sess = ShardedCallSession(index, cfg, mesh, routed=routed, batch=batch)
    return run_session(sess, [(contexts, counters)], cfg, batch)


def release(stats: dict) -> None:
    """Once a mesh's session is done and its tensors dropped, give the
    device memory that the caching allocator holds back to the cards,
    before the host genotypes and writes the VCF (so the process's exit
    has less to tear down); its seconds into ``stats["release_s"]``."""
    t0 = time.perf_counter()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()
    stats["release_s"] = time.perf_counter() - t0


# One position in SCAN_HIT_SHARE a hit: the most the scan's slots hold
# without a spill where the hits spread evenly over the owners.  At chr
# scale 22,067 of 10^7 positions hit, 21,824 of them on one owner (PERF.md
# section 6): a third of one pair's slots, had they all come in one chunk.
SCAN_HIT_SHARE = 4


def scan_capacity(slice_rows: int, n_shards: int) -> int:
    """Slot rows per (source, owner) pair of the sharded context scan for
    source slices of ``slice_rows`` positions: an even share of one hit in
    SCAN_HIT_SHARE positions, at least 128, at most a slice."""
    return min(slice_rows, max(128, -(-slice_rows // (SCAN_HIT_SHARE * n_shards))))


class ScanRouter:
    """The sharded context scan's step (JAX ``make_sharded_ref_scan :519``)
    and its buffers on the mesh, made once per scan: on each shard's
    device, two sets of the D slot blocks it receives (one block per
    source, ``cap`` rows each, rows of W words:
    :func:`kernels.scan_row_words`), one for the chunks of each parity,
    and, where an owner lies on another device, the blocks it sends there;
    its overflow list (a slice's rows) and tally; on CUDA, K8's scratch
    per card, the copy streams and events (:func:`copy_plan`, a hop per
    parity) and a step plan per parity.

    :meth:`step` scans positions ``[start, start + S * slice_rows)`` of one
    contig, slice s on shard s: K8 (``kernels.scan_pack``) sets in shard
    s's context words the rows it received in the previous chunk (the
    other parity's blocks: its prologue's rows), and hashes each position's
    windows (the ref_k - 1 halo read from the contig), probes the alt words
    (one copy per device) and packs each hit, by the owner of its context
    word, into that owner's slot block of this chunk's parity, in position
    order; the blocks go card to card.  On CUDA that is one C call
    (``kernels.scan_step``) and no host read.  :meth:`flush` sets the last
    chunk's rows, K9 (``kernels.scan_set``) on each owner.  A hit past
    ``cap`` goes to the source's overflow list; :meth:`finish` reads the
    tallies once, at the end, and sets the listed bits on their owners.
    Setting a bit is idempotent, so a scan whose lists overflowed is run
    again with slots of a whole slice (:func:`build_context_sharded`), which
    cannot spill."""

    def __init__(self, mesh, ctx: list, bf_words: dict, k: int, ref_k: int, size_bits: int,
                 slice_rows: int, cap: int | None = None):
        self.mesh, self.ctx, self.bf_words = tuple(mesh), ctx, bf_words
        D = self.D = len(self.mesh)
        self.k, self.ref_k, self.size_bits = k, ref_k, size_bits
        self.wps = size_bits // 32 // D
        self.W = kernels.scan_row_words(self.wps)
        self.slice_rows = slice_rows
        self.cap = scan_capacity(slice_rows, D) if cap is None else cap
        self.ovf_cap = max(1, slice_rows)
        self.cuda = self.mesh[0].type == "cuda"
        w = self.words = kernels.scan_slot_words(self.cap, self.W)
        cross = [[a != b for b in self.mesh] for a in self.mesh]
        self.pairs = [(s, d) for s in range(D) for d in range(D) if cross[s][d]]

        def zeros(n, dev, dtype=torch.int32):
            return torch.zeros(n, dtype=dtype, device=dev)

        # recv[p][d]: the blocks owner d receives in the chunks of parity p
        self.recv = [[zeros(D * w, dev) for dev in self.mesh] for _ in range(2)]
        self.send = [zeros(D * w, dev) if any(cross[s]) else None
                     for s, dev in enumerate(self.mesh)]
        self.out = [[[self.send[s][d * w : (d + 1) * w] if cross[s][d]
                      else recv[d][s * w : (s + 1) * w] for d in range(D)] for s in range(D)]
                    for recv in self.recv]
        self.overflow = [zeros(self.ovf_cap * (self.W + 1), dev) for dev in self.mesh]
        self.tally = [zeros(1 + D, dev, torch.int64) for dev in self.mesh]
        self.slot_bytes = 4 * w * len(self.pairs)  # a chunk's copies
        self.parity = 0  # of the next chunk
        self.copies = self.plans = None
        if self.cuda:
            cards = cards_of(self.mesh)
            self.scratch = {d: kernels.route_scratch(d, D) for d in cards}
            self._keep: list = []
            if self.pairs:
                plan = copy_plan(self.mesh, self.pairs, [(r, self.send, w) for r in self.recv],
                                 self._keep)
                hops = plan.pop("hops")
                # a chunk of parity p writes recv[p]: its copies wait for the
                # event recorded after the K8 whose prologue last read recv[p]
                # (hops[p]["done"], the previous chunk's), and the K8s here,
                # which read recv[1 - p], record hops[1 - p]["done"]
                self.copies = [{**plan, **hops[p], "guard": hops[p]["done"],
                                "done": hops[1 - p]["done"]} for p in range(2)]
            self.plans = [self._plan(p) for p in range(2)]

    def _plan(self, p: int) -> np.ndarray:
        """The scan step's plan of the chunks of parity ``p`` for
        ``kernels.scan_step``: each shard's device and buffers (columns from
        ``kernels.scan_layout``), its blocks for each owner in ``recv[p]``
        (or to send), the blocks its prologue sets in ``recv[1 - p]``; the
        slice, stream and events go in at each chunk."""
        P = self.P = kernels.scan_layout()[1]
        if self.D > P["max_dests"]:
            raise ValueError(f"the sharded scan takes at most {P['max_dests']} shards, got "
                             f"{self.D}")
        plan = np.zeros((self.D, P["width"]), dtype=np.int64)
        for s, dev in enumerate(self.mesh):
            for t, name in ((self.ctx[s], "ctx_words"), (self.bf_words[dev], "bf_words")):
                kernels._check(t, torch.int32, name)
                if t.device != dev:
                    raise ValueError(f"shard {s}'s {name} lies on {t.device}, not {dev}")
            if self.ctx[s].numel() != self.wps:
                raise ValueError(f"shard {s} holds {self.ctx[s].numel()} context words, not "
                                 f"{self.wps}")
            row = plan[s]
            row[P["dev"]] = dev.index
            for name, t in (("bf_words", self.bf_words[dev]), ("ovf", self.overflow[s]),
                            ("tally", self.tally[s]), ("scratch", self.scratch[dev]),
                            ("set", self.recv[1 - p][s]), ("ctx_words", self.ctx[s])):
                row[P[name]] = t.data_ptr()
            row[P["out"] : P["out"] + self.D] = [b.data_ptr() for b in self.out[p][s]]
        return plan

    def _slice(self, s: int, start: int, n_pos: int) -> tuple[int, int]:
        """Shard s's first position and count in the chunk at ``start``."""
        p0 = start + s * self.slice_rows
        return p0, max(0, min(self.slice_rows, n_pos - p0))

    def step(self, seqs: dict, start: int, n_pos: int, stats: dict,
             events: dict | None = None) -> None:
        """One chunk of the contig ``seqs[device]`` (a copy per device) of
        ``n_pos`` positions, from ``start``; with ``events``, the K8
        launches are timed (a list under "scan_pack")."""
        D, cap, ref_k, p = self.D, self.cap, self.ref_k, self.parity
        for s in range(D):
            stats["positions"] += self._slice(s, start, n_pos)[1]
        stats["slot_bytes"] += self.slot_bytes
        self.parity ^= 1
        if self.plans is not None:
            return self._step_cuda(p, seqs, start, n_pos, events)
        for s, dev in enumerate(self.mesh):
            p0, n = self._slice(s, start, n_pos)
            kernels.scan_pack(seqs[dev][p0 : p0 + n + ref_k - 1] if n else seqs[dev][:0], n,
                              self.bf_words[dev], self.out[p][s], self.overflow[s], self.tally[s],
                              k=self.k, ref_k=ref_k, size_bits=self.size_bits, wps=self.wps,
                              cap=cap, prior=(self.ctx[s], self.recv[1 - p][s]))
        self._copy(p)

    def _copy(self, p: int) -> None:
        """Off CUDA, the blocks of a chunk of parity ``p`` to their owners
        on other devices, by tensor copies (on CUDA the step's C call
        copies)."""
        w = self.words
        for s, d in self.pairs:
            self.recv[p][d][s * w : (s + 1) * w].copy_(self.send[s][d * w : (d + 1) * w])

    def _step_cuda(self, p: int, seqs: dict, start: int, n_pos: int,
                   events: dict | None) -> None:
        P, plan = self.P, self.plans[p]
        for s, dev in enumerate(self.mesh):
            p0, n = self._slice(s, start, n_pos)
            seq = seqs[dev]
            kernels._check(seq, torch.uint8, "seq")
            if n and (seq.device != dev or seq.numel() < p0 + n + self.ref_k - 1):
                raise ValueError(f"shard {s}: the contig on {seq.device} ends before position "
                                 f"{p0 + n + self.ref_k - 1}")
            stream = torch.cuda.current_stream(dev)
            plan[s, P["seq"]], plan[s, P["n_pos"]] = seq.data_ptr() + (p0 if n else 0), n
            plan[s, P["stream"]] = stream.cuda_stream
            ev = step_events(events, "scan_pack", dev)
            if ev is not None:
                for e in ev:  # a torch event makes its CUDA event at its first record
                    e.record(stream)
            plan[s, P["ev_pack0"] : P["ev_pack0"] + 2] = [e.cuda_event for e in ev] if ev else 0
        kernels.scan_step(plan, k=self.k, ref_k=self.ref_k, size_bits=self.size_bits,
                          wps=self.wps, W=self.W, cap=self.cap, ovf_cap=self.ovf_cap,
                          copies=self.copies and self.copies[p])

    def flush(self, events: dict | None = None) -> None:
        """The last chunk's rows set on their owners: K9 on each owner over
        the blocks it received in that chunk (on its device's current
        stream, after the chunk's copies); with ``events``, each launch is
        timed (a list under "scan_set")."""
        last = self.recv[1 - self.parity]
        for d, dev in enumerate(self.mesh):
            ev = step_events(events, "scan_set", dev)
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                if ev is not None:
                    ev[0].record()
                kernels.scan_set(self.ctx[d], last[d], n_blocks=self.D, cap=self.cap, W=self.W)
                if ev is not None:
                    ev[1].record()

    def finish(self, stats: dict) -> bool:
        """Read every card's tally once: add the slot rows each owner got
        to ``stats["hits"]`` and the spilled rows to
        ``stats["overflow_rows"]``, then set each listed bit on its owner
        (K9 over a block of the list's rows for that owner, the rows of
        other owners sorted past its count).  False, with nothing set from
        the lists, where a list took more rows than it holds."""
        D, W, oc = self.D, self.W, self.ovf_cap
        tallies = read_host(self.tally)
        stats["host_reads_end"] += 1
        for d in range(D):
            stats["hits"][d] += sum(t[1 + d] for t in tallies)
        spilled = [t[0] for t in tallies]
        stats["overflow_rows"] += sum(spilled)
        if max(spilled) > oc:
            return False
        for s, n in enumerate(spilled):
            if n == 0:
                continue
            rows = self.overflow[s].view(W + 1, oc)[:, :n]
            owner = rows[W]
            for d in range(D):
                mine = owner == d
                order = torch.sort((~mine).to(torch.uint8), stable=True)[1]
                head = torch.zeros(kernels.SLOT_HEAD, dtype=torch.int32, device=owner.device)
                head[0] = mine.sum()
                block = torch.cat([head, rows[:W, order].reshape(-1)])
                kernels.scan_set(self.ctx[d], block.to(self.mesh[d]), n_blocks=1, cap=n, W=W)
        return True


def build_context_sharded(index, refs_used: list[np.ndarray], cfg: Config, mesh,
                          slice_chunk: int = 1 << 20) -> None:
    """The reference context scan over a mesh (JAX ``:582``), updating
    ``index.context_bf.words``; equivalent to the host scan.  Short contigs
    go first, on the host.  Peer access goes on between the mesh's cards
    (:func:`enable_peer`); the alt words and each contig cross from the
    host once, to the mesh's first device, and are copied from there to
    its other devices (virtual shards of one device share one copy); each
    shard's context words cross as its slice; each chunk of ``S *
    slice_chunk`` positions is one :meth:`ScanRouter.step` (slots of
    :func:`scan_capacity` rows), with no host read; the tallies come back
    once, and the words sparse."""
    S = len(mesh)
    check_bloom_size(cfg.bf_size)
    W = index.bf.words.shape[0]
    if W % S:
        raise ValueError(f"{W} Bloom words do not split into {S} shards")
    wps = W // S
    short_contigs_on_host(index, refs_used, cfg)

    devices = cards_of(mesh)
    times: dict = {}
    t = t0 = time.perf_counter()

    def mark(name: str, since: float, sync: bool = True) -> float:
        if sync:
            synchronize(devices)
        now = time.perf_counter()
        times[name] = times.get(name, 0.0) + now - since
        return now

    enable_peer(devices)
    t = mark("peer access", t)
    first = upload([index.bf.words], devices[:1])[0]
    t = mark("alt words upload", t)
    bf_words = replicate(first, devices)
    t = mark("alt words replicated", t)
    ctx = upload(row_slices(index.context_bf.words, S), mesh)
    t = mark("context words upload", t)
    router = ScanRouter(mesh, ctx, bf_words, cfg.k, cfg.ref_k, cfg.bf_size, slice_chunk)
    t = mark("buffers", t)
    timed = mesh[0].type == "cuda"
    stats = {"positions": 0, "chunks": 0, "hits": [0] * S, "overflow_rows": 0,
             "host_reads_chunks": 0, "host_reads_end": 0, "rescans": 0, "slot_bytes": 0}
    events = {"scan_pack": [], "scan_set": []} if timed else None
    while True:
        for ref in refs_used:
            if len(ref) < cfg.ref_k:
                continue
            seqs = replicate(upload([ref.astype(np.uint8, copy=False)], devices[:1])[0], devices)
            t = mark("contigs", t, sync=False)
            n_pos = len(ref) - cfg.ref_k + 1
            reads = HOST_READS[0]
            for start in range(0, n_pos, S * slice_chunk):
                router.step(seqs, start, n_pos, stats, events)
                stats["chunks"] += 1
            stats["host_reads_chunks"] += HOST_READS[0] - reads
            t = mark("chunks", t, sync=False)
        router.flush(events)
        t = mark("chunks", t)
        if router.finish(stats):
            break
        # an overflow list overflowed: scan again with slots that cannot spill
        stats["rescans"] += 1
        router = ScanRouter(mesh, ctx, bf_words, cfg.k, cfg.ref_k, cfg.bf_size, slice_chunk,
                            cap=slice_chunk)
    t = mark("overflow and tallies", t)
    for s, words in enumerate(ctx):  # the scan only sets bits: nonzero words stay nonzero
        nz = torch.nonzero(words).squeeze(1)
        index.context_bf.words[s * wps + nz.cpu().numpy()] = to_u32(words[nz])
    t = mark("read-back", t)
    k8, k9 = (events_ms(events[n]) if timed else None for n in ("scan_pack", "scan_set"))
    again = f", scanned {stats['rescans']} times more" if stats["rescans"] else ""
    print(f"[{TAG}] sharded context scan: {stats['positions']} positions in {stats['chunks']} "
          f"chunks over {S} shards ({', '.join(map(str, mesh))}); hits routed to their "
          f"context-word owners {stats['hits']} in the slots, {stats['overflow_rows']} rows "
          f"through the overflow lists{again}; host reads {stats['host_reads_chunks']} in the "
          f"chunks, {stats['host_reads_end']} at the end; slots of {router.cap} rows of "
          f"{4 * router.W} bytes a (source, owner) pair, {stats['slot_bytes']} bytes of them "
          f"copied card to card; K8 {k8} ms, K9 {k9} ms (launcher events); "
          + ", ".join(f"{n} {v:.6g} s" for n, v in times.items())
          + f"; {time.perf_counter() - t0:.6g} s in all", file=sys.stderr)


def log_sharded_step(stats: dict) -> None:
    """One stderr line with the sharded call step's rows, routing and the
    device time of its kernels (launcher events)."""
    if stats["design"] == "routed":
        rows, kernel = f"hop 1 {stats['hop1_rows']}, hop 2 {stats['hop2_rows']}", "K4"
        waits = (f"; host reads {stats['host_reads']} in all, none in the steps (the overflow "
                 f"lists' sizes at the end; {stats['overflow_rows']} rows rerun from them); "
                 f"slots of {stats['slot_rows']} rows a (source, destination) pair, "
                 f"{stats['slot_bytes']} bytes of them copied card to card")
    else:
        rows, kernel = f"gathered {stats['gathered_rows']}", "K5"
        waits = "; no host wait in the steps"
    print(f"[{TAG}/metrics] sharded call step ({stats['design']}): {stats['rows']} distinct "
          f"k-mers in {stats['steps']} steps over {stats['shards']} shards; rows per shard, "
          f"{rows}; device time K1 hash-only {stats['hash_ms']} ms, {kernel} "
          f"{stats['kernel_ms']} ms (launcher events){waits}; index upload "
          f"{stats['upload_s']:.6g} s, write-back {stats['writeback_s']:.6g} s, device memory "
          f"released in {stats.get('release_s', 0.0):.6g} s", file=sys.stderr)
