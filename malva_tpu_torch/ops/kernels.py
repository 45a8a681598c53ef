"""The hand-written kernels of the device paths, their wrappers and their
plain PyTorch versions.

Counterpart of ``malva_tpu/ops/pallas_kernels.py``.  Each wrapper takes
the plain version for tensors on the CPU, and for CUDA tensors launches
its kernel (``csrc/``, built by ``ops/_build.py``) or raises; it never
falls back.  ``LAUNCHES`` counts kernel launches per wrapper.

* K1 ``callstep`` (``csrc/callstep.cu``) replaces
  ``pallas_kernels.py:125 make_callstep_hash_fn`` and the rest of
  ``index/device.py:400 make_call_step_packed``.  On the card it is bound
  by one random 8-byte row gather per lane from the GiB-sized word+rank
  array; the kernel hashes in registers, keeps a tile's gathers in flight
  while it hashes the next, and queues the few lanes that go on to the
  context filter and the exact map for the whole warp.
* K2 ``ref_scan`` (``csrc/ref_scan.cu``) replaces
  ``pallas_kernels.py:222 make_window_hash_fn`` and the rest of
  ``index/device.py:697 make_ref_scan_step_pallas``.  It is bound by one
  random 4-byte alt-filter read per reference position; the chunk and its
  reverse complement sit in shared memory, where the canonical forms are
  compared and hashed in place, and hits end in one ``atomicOr``.

* K3 ``seq_pack`` (``csrc/seq_count.cu``) has no Pallas counterpart: it
  replaces the XLA front end of ``malva_tpu/count/device_count.py:64
  make_seq_sort_count_step`` (window matrix, validity, canonical form,
  2-bit pack) with one pass over the raw read chunk; the sort and run
  count after it are torch's (``count/device_count.py``).

* K4 ``shard_update`` (``csrc/shard_step.cu``) has no Pallas counterpart:
  it replaces the XLA owner-side tail of the routed sharded step
  (``malva_tpu/parallel/sharded_index.py:398-424``), run on the shard that
  owns a lane's Bloom word.  It is K1's kernel template (``csrc/step.cuh``)
  with its own policy, and bound like K1: one row gather per lane, with
  the probe only for the few lanes the shard's mini-filter lets through.

* K5 ``gather_update`` (``csrc/shard_step.cu``, ``csrc/gather.cuh``) has
  no Pallas counterpart: it replaces the XLA body of the all-gather
  sharded step (``malva_tpu/parallel/sharded_index.py:141-183``), run on
  every shard over the whole gathered batch.  It reads the centre hashes
  and canonical centres that K1 hash-only already wrote on the shard, so
  it hashes nothing: a warp's ballots queue the lanes whose Bloom word is
  the shard's (a row to gather) and those with a bucket of the shard's (a
  probe), and a pass issues both kinds of random reads together.

K4 has a second entry, ``shard_update_slots`` (``csrc/shard_step.cu``,
the routed step's path): its lanes are the rows of the hop-2 slot blocks,
masked past each block's count.  ``LAUNCHES["shard_update"]`` counts the
launches of both entries (K4's), ``LAUNCHES["shard_update_slots"]`` those
of the slot entry alone.

* K6 ``route_pack`` and K7 ``route_probe`` (``csrc/route.cu``) have no
  Pallas counterpart: they replace ``pack_dests``
  (``malva_tpu/parallel/sharded_index.py:326-347``) for hop 1, and the
  hop-1 owner's context-filter test with ``pack_dests`` for hop 2
  (``:383-394``).  Each writes the rows of its lanes into fixed slot
  blocks, one per destination, in lane order (as the stable sort of
  ``pack_dests``), with the row count in each block's header, and appends
  a lane past the capacity to the card's overflow list.  Each wrapper
  launches one kernel, a single pass over tiles of 2048 lanes: a tile ranks
  its lanes by destination in registers, publishes its counts and looks
  back over the tiles before it for its bases (decoupled look-back, in a
  zeroed scratch that each launch leaves zeroed), stages its rows in
  shared memory grouped by destination and writes each destination's
  rows as runs.  They are bound by bytes: each lane's words read once,
  each row written once.

* K8 ``scan_pack`` and K9 ``scan_set`` are the sharded context scan's
  (``parallel/sharded_index.py``), K2's sharded entry: on each shard's
  slice of a chunk, K8 is one launch of K2's tile code in a pack mode
  whose tiles partition their hits (positions whose centre hits the alt
  filter) by the owner of their context word into fixed slot blocks, in
  position order, with K6's look-back (``csrc/ref_scan.cu``,
  ``csrc/partition.cuh``, ``csrc/route.cuh``), each row the shard-local
  bit index of the context; no per-position code is written.  K9 ORs the
  rows of the blocks an owner received into its context words.  In the
  sharded scan K8's launch for a chunk does that first for the previous
  chunk's blocks (its prologue, ``prior``), so K9 launches once an owner,
  for the last chunk.  They replace the hit all-gather and ``bloom_set``
  of ``malva_tpu/parallel/sharded_index.py:519-569``.

``callstep_hash`` / ``window_hash`` are the kernels' hash-only modes,
which write exactly the TPU kernels' outputs so the card can check them
against the TPU kernels' contract.

Device arrays are int32 tensors holding uint32 bit patterns (ops.bloom).
Hash-only outputs are returned as int64 lanes in [0, 2^32).

The call-step wrappers (``callstep``, ``callstep_hash``, ``shard_update``,
``gather_update``) take ``events=(start, stop)``, two
``torch.cuda.Event(enable_timing=True)``; the C launcher records them on
the launch stream just before and after the kernel, inside the one ctypes
call that holds no GIL, behind a hold that keeps the card from taking the
start event before the kernel is queued, so their elapsed time is the
kernel's device time (``csrc/launch.cuh``).
"""

from __future__ import annotations

import torch

from ..index.kmap_table import SLOTS, probe_bucket_table
from . import _build
from .bloom import M32, bloom_set, lanes, scatter_add_u32, storage
from .packed import (canonical_center, canonical_decision, complement, decode_byte_cols,
                     popcount32)
from .xxh3 import check_bloom_size
from .xxh3_torch import xxh3_64_cols, xxh3_mod_size

LAUNCHES = {"callstep": 0, "ref_scan": 0, "seq_pack": 0, "shard_update": 0, "gather_update": 0,
            "shard_update_slots": 0, "route_pack": 0, "route_probe": 0, "scan_pack": 0,
            "scan_set": 0}
MAX_LEN = 240  # csrc/lanes.cuh kMaxLen


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for tensors on one CUDA device, False for CPU tensors; raises
    on a mix (two cards of a mesh included) or any other device."""
    devices = {t.device for t in tensors}
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len(devices) == 1:
        return True
    raise ValueError(f"kernel inputs must all lie on one CPU or CUDA device, got {devices}")


def _check(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor, got {t.dtype}"
                         f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _check_lengths(k: int, ref_k: int) -> None:
    if not (1 <= k <= ref_k <= MAX_LEN):
        raise ValueError(f"kernels need 1 <= k <= ref_k <= {MAX_LEN}, got k={k} ref_k={ref_k}")


_TIMED = ("malva_callstep", "malva_callstep_hash", "malva_shard_update", "malva_gather_update",
          "malva_shard_update_slots")


def _launch(fn_name: str, device: torch.device, *args, events=None) -> None:
    """Launch ``fn_name`` on the current stream of ``device``; a timed
    launcher also gets the handles of ``events`` (or nulls)."""
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        if fn_name in _TIMED:
            handles = (None, None)
            if events is not None:
                for ev in events:  # a torch event makes its CUDA event at its first record
                    ev.record(stream)
                handles = tuple(ev.cuda_event for ev in events)
            args += handles
        err = getattr(lib, fn_name)(*args, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {err}")


# -- K1: call step ------------------------------------------------------------


def callstep_hash_plain(ctx_packed: torch.Tensor, k: int, ref_k: int, with_ctx: bool):
    """Plain K1 front end: ``[ctx_hi, ctx_lo,] c_hi, c_lo, can_0..`` of
    (B, wc) packed contexts, as int64 lanes."""
    words = [lanes(ctx_packed[:, j]) for j in range(ctx_packed.shape[1])]
    out = []
    if with_ctx:
        out += list(xxh3_64_cols(decode_byte_cols(words, ref_k)))
    can = canonical_center(words, k, ref_k)
    out += list(xxh3_64_cols(decode_byte_cols(can, k)))
    return out + can


def callstep_hash(ctx_packed: torch.Tensor, k: int, ref_k: int, with_ctx: bool, events=None):
    """K1 in hash-only mode; same outputs as :func:`callstep_hash_plain`."""
    if not _on_cuda(ctx_packed):
        return callstep_hash_plain(ctx_packed, k, ref_k, with_ctx)
    return [lanes(o) for o in callstep_hash_words(ctx_packed, k, ref_k, with_ctx, events)]


def callstep_hash_words(ctx_packed: torch.Tensor, k: int, ref_k: int, with_ctx: bool,
                        events=None) -> torch.Tensor:
    """K1 in hash-only mode, its outputs as they leave the kernel: one
    (n_out, B) int32 tensor, the planes of :func:`callstep_hash_plain` as
    uint32 bits (what K6 reads)."""
    if not _on_cuda(ctx_packed):
        return torch.stack([storage(o) for o in
                            callstep_hash_plain(ctx_packed, k, ref_k, with_ctx)])
    _check(ctx_packed, torch.int32, "ctx_packed")
    _check_lengths(k, ref_k)
    B, wc = ctx_packed.shape
    if wc != (ref_k + 15) // 16:
        raise ValueError(f"ctx_packed has {wc} words a row; ref_k={ref_k} needs "
                         f"{(ref_k + 15) // 16}")
    n_out = (4 if with_ctx else 2) + (k + 15) // 16
    out = torch.empty((n_out, B), dtype=torch.int32, device=ctx_packed.device)
    _launch("malva_callstep_hash", ctx_packed.device, ctx_packed.data_ptr(), B, wc, k, ref_k,
            int(with_ctx), out.data_ptr(), events=events)
    LAUNCHES["callstep"] += 1
    return out


def callstep_plain(bf_packed, ctx_words, kmap_keys, state, ctx_packed, counters, *,
                   k: int, ref_k: int, size_bits: int, n_buckets: int,
                   minifilter: bool) -> None:
    """Plain call step over packed contexts, updating ``state`` in place.

    The full-batch spec of ``malva_tpu/index/device.py:195 make_call_step``
    over packed input.  ``state`` is ``[bf_counts | kmap_vals]``;
    ``counters`` of 0 are exact no-ops (padding)."""
    from ..index.device import RANK_BITS, RANK_MASK  # index.device imports this module

    counts_len = state.shape[0] - n_buckets * SLOTS
    w_k = (k + 15) // 16
    words = [lanes(ctx_packed[:, j]) for j in range(ctx_packed.shape[1])]
    can = canonical_center(words, k, ref_k)
    c_hi, c_lo = xxh3_64_cols(decode_byte_cols(can, k))
    bw, bb = xxh3_mod_size(c_hi, c_lo, size_bits)
    row = lanes(bf_packed[bw])
    word, aux = row[:, 0], row[:, 1]
    is_set = ((word >> bb) & 1).bool()
    rank = aux & RANK_MASK if minifilter else aux
    cnt_idx = rank + popcount32(word & ((1 << bb) - 1))

    x_hi, x_lo = xxh3_64_cols(decode_byte_cols(words, ref_k))
    cw, cb = xxh3_mod_size(x_hi, x_lo, size_bits)
    ctx_known = ((lanes(ctx_words[cw]) >> cb) & 1).bool()
    scatter_add_u32(state, cnt_idx, counters, is_set & ~ctx_known)

    if minifilter and n_buckets > 1:
        cand = (((aux >> RANK_BITS) >> ((c_hi >> 28) & 3)) & 1).bool()
    else:
        cand = torch.ones_like(is_set)
    slot, found = probe_bucket_table(kmap_keys, n_buckets, w_k, can, c_hi, c_lo)
    scatter_add_u32(state, counts_len + slot, counters, found & cand)


def callstep(bf_packed, ctx_words, kmap_keys, state, ctx_packed, counters, *,
             k: int, ref_k: int, size_bits: int, n_buckets: int, minifilter: bool,
             events=None) -> None:
    """K1: one call step over (B, wc) packed canonical contexts and their
    (B,) counters, updating ``state`` in place.  All arrays are int32
    storage; ``bf_packed`` is (W, 2) [word, rank | mini-filter << 28]."""
    args = (bf_packed, ctx_words, kmap_keys, state, ctx_packed, counters)
    if not _on_cuda(*args):
        return callstep_plain(*args, k=k, ref_k=ref_k, size_bits=size_bits,
                              n_buckets=n_buckets, minifilter=minifilter)
    names = ("bf_packed", "ctx_words", "kmap_keys", "state", "ctx_packed", "counters")
    for t, name in zip(args, names):
        _check(t, torch.int32, name)
    _check_lengths(k, ref_k)
    check_bloom_size(size_bits)
    B, wc = ctx_packed.shape
    W = size_bits // 32
    if (wc != (ref_k + 15) // 16 or counters.shape != (B,) or bf_packed.shape != (W, 2)
            or ctx_words.shape != (W,)
            or kmap_keys.shape != (n_buckets, SLOTS * ((k + 15) // 16))
            or state.shape[0] < n_buckets * SLOTS):
        raise ValueError("callstep: array shapes do not match k, ref_k, size_bits and n_buckets")
    counts_len = state.shape[0] - n_buckets * SLOTS
    _launch("malva_callstep", state.device, ctx_packed.data_ptr(), counters.data_ptr(), B, wc,
            k, ref_k, bf_packed.data_ptr(), ctx_words.data_ptr(), kmap_keys.data_ptr(),
            state.data_ptr(), counts_len, n_buckets, size_bits, int(minifilter), events=events)
    LAUNCHES["callstep"] += 1


# -- K4: owner side of the routed sharded call step ----------------------------


def shard_update_plain(bf_packed, kmap_keys, state, ctx_packed, counters, known, *, k: int,
                       ref_k: int, size_bits: int, n_buckets: int, word_base: int,
                       counts_len: int, minifilter: bool) -> None:
    """Plain K4 over one shard, updating ``state`` in place.

    ``bf_packed`` is the shard's (W/S, 2) [word, local rank] rows for
    global words ``word_base ..`` (with the shard's exact-map mini-filter
    in the rank's top 4 bits where ``minifilter``), ``kmap_keys`` its
    (n_buckets, SLOTS * w_k) bucket table and ``state`` its ``[bf_counts
    (counts_len) | kmap_vals]``.  Each lane (packed context, counter,
    ``known``: its context is in the context filter) adds its counter to
    the rank counter of its centre's Bloom bit when that bit is set and the
    context is not known, and to the exact-map slot of its centre when
    there is one and the mini-filter (where on) lets it probe, as
    :func:`callstep_plain` does (malva_tpu/parallel/sharded_index.py:398-424).
    Lanes whose Bloom word lies outside the shard are no-ops."""
    from ..index.device import RANK_BITS, RANK_MASK  # index.device imports this module

    words = [lanes(ctx_packed[:, j]) for j in range(ctx_packed.shape[1])]
    can = canonical_center(words, k, ref_k)
    c_hi, c_lo = xxh3_64_cols(decode_byte_cols(can, k))
    bw, bb = xxh3_mod_size(c_hi, c_lo, size_bits)
    lw = bw - word_base
    mine = (lw >= 0) & (lw < bf_packed.shape[0])
    row = lanes(bf_packed[torch.where(mine, lw, 0)])
    word, aux = row[:, 0], row[:, 1]
    is_set = ((word >> bb) & 1).bool()
    rank = aux & RANK_MASK if minifilter else aux
    cnt_idx = rank + popcount32(word & ((1 << bb) - 1))
    scatter_add_u32(state, cnt_idx, counters, mine & is_set & ~known)
    if minifilter and n_buckets > 1:
        cand = (((aux >> RANK_BITS) >> ((c_hi >> 28) & 3)) & 1).bool()
    else:
        cand = torch.ones_like(is_set)
    slot, found = probe_bucket_table(kmap_keys, n_buckets, (k + 15) // 16, can, c_hi, c_lo)
    scatter_add_u32(state, counts_len + slot, counters, mine & found & cand)


def shard_update(bf_packed, kmap_keys, state, ctx_packed, counters, known, *, k: int,
                 ref_k: int, size_bits: int, n_buckets: int, word_base: int, counts_len: int,
                 minifilter: bool, events=None) -> None:
    """K4: the owner-side update of routed lanes on one shard; same
    effect as :func:`shard_update_plain`.  ``known`` is a bool tensor."""
    args = (bf_packed, kmap_keys, state, ctx_packed, counters, known)
    kw = dict(k=k, ref_k=ref_k, size_bits=size_bits, n_buckets=n_buckets, word_base=word_base,
              counts_len=counts_len, minifilter=minifilter)
    if not _on_cuda(*args):
        return shard_update_plain(*args, **kw)
    for t, name in zip(args[:5], ("bf_packed", "kmap_keys", "state", "ctx_packed", "counters")):
        _check(t, torch.int32, name)
    _check(known, torch.bool, "known")
    _check_lengths(k, ref_k)
    check_bloom_size(size_bits)
    B, wc = ctx_packed.shape
    if (wc != (ref_k + 15) // 16 or counters.shape != (B,) or known.shape != (B,)
            or bf_packed.dim() != 2 or bf_packed.shape[1] != 2
            or kmap_keys.shape != (n_buckets, SLOTS * ((k + 15) // 16))
            or state.shape != (counts_len + n_buckets * SLOTS,) or B >= 1 << 32):
        raise ValueError("shard_update: array shapes do not match k, ref_k, n_buckets and "
                         "counts_len (or 2^32 lanes or more)")
    _launch("malva_shard_update", state.device, ctx_packed.data_ptr(), counters.data_ptr(),
            known.data_ptr(), B, wc, k, ref_k, bf_packed.data_ptr(), word_base,
            bf_packed.shape[0], kmap_keys.data_ptr(), state.data_ptr(), counts_len, n_buckets,
            size_bits, int(minifilter), events=events)
    LAUNCHES["shard_update"] += 1


# -- K5: shard side of the all-gather sharded call step -------------------------


def gather_update_plain(bf_packed, kmap_keys, state, centre, counters, known, *, k: int,
                        size_bits: int, n_buckets: int, word_base: int, bucket_base: int,
                        counts_len: int) -> None:
    """Plain K5 over one shard, updating ``state`` in place: the body of
    malva_tpu/parallel/sharded_index.py:128-185 (make_sharded_call_step).

    ``centre`` is K1 hash-only's (2 + w_k, B) int32 planes of the gathered
    batch, [c_hi, c_lo, can_0 .. can_{w_k-1}]: each lane's centre hash and
    canonical centre (:func:`callstep_hash_words`'s planes past the context
    hash).  ``bf_packed`` is the shard's (W/S, 2) [word, local rank] rows
    (no mini-filter) for global words ``word_base ..``, ``kmap_keys`` its
    (nbps, SLOTS * w_k) slice of the global bucket table of ``n_buckets``,
    buckets ``bucket_base ..``, and ``state`` its ``[bf_counts (counts_len)
    | kmap_vals (nbps * SLOTS)]``.  Every lane of the gathered batch
    (counter, ``known``: the context-filter flags OR-merged over the
    shards) adds its counter to the rank counter of its centre's Bloom bit
    when the word is this shard's, the bit is set and the context is not
    known (JAX ``:152-163``), and to the exact-map slot of its centre where
    one of its global buckets is this shard's and holds it, gated neither
    by the bit nor by ``known`` (JAX ``:169-183``)."""
    w_k = (k + 15) // 16
    c_hi, c_lo = lanes(centre[0]), lanes(centre[1])
    can = [lanes(centre[2 + j]) for j in range(w_k)]
    bw, bb = xxh3_mod_size(c_hi, c_lo, size_bits)
    lw = bw - word_base
    mine = (lw >= 0) & (lw < bf_packed.shape[0])
    row = lanes(bf_packed[torch.where(mine, lw, 0)])
    word, rank = row[:, 0], row[:, 1]
    is_set = ((word >> bb) & 1).bool()
    cnt_idx = rank + popcount32(word & ((1 << bb) - 1))
    scatter_add_u32(state, cnt_idx, counters, mine & is_set & ~known)
    slot, found = probe_bucket_table(kmap_keys, n_buckets, w_k, can, c_hi, c_lo,
                                     base=bucket_base)
    scatter_add_u32(state, counts_len + slot, counters, found)


def gather_update(bf_packed, kmap_keys, state, centre, counters, known, *, k: int,
                  size_bits: int, n_buckets: int, word_base: int, bucket_base: int,
                  counts_len: int, events=None) -> None:
    """K5: the shard side of the all-gather step on one shard; same effect
    as :func:`gather_update_plain`, over K1 hash-only's ``centre`` planes
    (it hashes nothing).  ``known`` is a bool tensor."""
    args = (bf_packed, kmap_keys, state, centre, counters, known)
    kw = dict(k=k, size_bits=size_bits, n_buckets=n_buckets, word_base=word_base,
              bucket_base=bucket_base, counts_len=counts_len)
    if not _on_cuda(*args):
        return gather_update_plain(*args, **kw)
    for t, name in zip(args[:5], ("bf_packed", "kmap_keys", "state", "centre", "counters")):
        _check(t, torch.int32, name)
    _check(known, torch.bool, "known")
    _check_lengths(k, k)
    check_bloom_size(size_bits)
    w_k = (k + 15) // 16
    B = counters.shape[0]
    nbps = kmap_keys.shape[0]
    if (centre.shape != (2 + w_k, B) or known.shape != (B,)
            or bf_packed.dim() != 2 or bf_packed.shape[1] != 2
            or kmap_keys.shape != (nbps, SLOTS * w_k)
            or not 0 <= bucket_base <= n_buckets - nbps
            or state.shape != (counts_len + nbps * SLOTS,) or B >= 1 << 32):
        raise ValueError("gather_update: array shapes do not match k, n_buckets, bucket_base "
                         "and counts_len (or 2^32 lanes or more)")
    if kmap_keys.data_ptr() % 16:
        raise ValueError("gather_update: the bucket table must be 16-byte aligned")
    _launch("malva_gather_update", state.device, centre.data_ptr(), counters.data_ptr(),
            known.data_ptr(), B, w_k, bf_packed.data_ptr(), word_base, bf_packed.shape[0],
            kmap_keys.data_ptr(), state.data_ptr(), counts_len, n_buckets, bucket_base, nbps,
            size_bits, events=events)
    LAUNCHES["gather_update"] += 1


# -- K6, K7 and K4's slot entry: the routed step's partitions -------------------
#
# A slot block: SLOT_HEAD header words ([rows, 0, 0, 0]), then cap rows as
# planes: the packed contexts (cap x wc words), then one plane of cap words
# per column.  Hop 1 (K6 -> K7): counter, context word less the owner's
# first word, context bit, Bloom-word owner.  Hop 2 (K7 -> K4): counter,
# "context known".  An overflow list of ovf_cap rows: [contexts (ovf_cap x
# wc) | counters (ovf_cap)].  A tally (int64): [rows appended to the
# overflow list, rows sent in hop 1 to each of the D shards, rows sent in
# hop 2 to each].  csrc/launch.cuh defines the same block format for the
# kernels; route_layout() checks that the two agree before a launch.

SLOT_HEAD = 4
HOP1_COLS, HOP2_COLS = 4, 2
ROUTE_MAX_LANES = 1 << 27  # lanes of one K6 or K7 launch (csrc/route.cuh kMaxTiles x kTileLanes)


def slot_words(cap: int, wc: int, cols: int) -> int:
    """Words of a slot block of ``cap`` rows of ``wc`` context words and
    ``cols`` further columns."""
    return SLOT_HEAD + cap * (wc + cols)


def slot_rows(block: torch.Tensor, cap: int, wc: int, cols: int) -> torch.Tensor:
    """The live rows of one slot block as (rows, wc + cols) int32, without
    a host read of the count (a mask over the cap rows)."""
    live = torch.arange(cap, device=block.device) < block[0].to(torch.int64)
    planes = block[SLOT_HEAD:].view(-1)
    ctx = planes[: cap * wc].view(cap, wc)
    more = planes[cap * wc :].view(cols, cap).t()
    return torch.cat([ctx, more], dim=1)[live]


def _partition(dest: torch.Tensor, rows: torch.Tensor, blocks: list, cap: int, wc: int,
               overflow: torch.Tensor, tally: torch.Tensor, at: int, slot_cols: int | None = None,
               ovf_cols: int = 1) -> None:
    """Plain partition of K6, K7 and K8: row i of ``rows`` (int32, wc +
    cols columns) goes to ``blocks[dest[i]]`` at its rank among the rows of
    that destination (lane order), where the rank is below ``cap``, as its
    contexts and first ``slot_cols`` columns (all by default); a row of rank
    cap or more goes to the overflow list, in lane order, as its contexts
    and first ``ovf_cols`` columns; a dest of ``len(blocks)`` goes nowhere."""
    D = len(blocks)
    cols = rows.shape[1] - wc if slot_cols is None else slot_cols
    sdest, order = torch.sort(dest, stable=True)
    first = torch.searchsorted(sdest, sdest)
    rank = torch.arange(sdest.shape[0], device=dest.device) - first
    srows = rows[order]
    for d in range(D):
        sel = (sdest == d) & (rank < cap)
        pos, got = rank[sel], srows[sel]
        planes = blocks[d][SLOT_HEAD:]
        planes[: cap * wc].view(cap, wc)[pos] = got[:, :wc]
        planes[cap * wc :].view(cols, cap)[:, pos] = got[:, wc : wc + cols].t()
        blocks[d][0] = torch.clamp((sdest == d).sum(), max=cap).to(torch.int32)
        tally[at + d] += blocks[d][0].to(torch.int64)
    over = torch.zeros_like(dest, dtype=torch.bool)
    over[order] = (sdest < D) & (rank >= cap)
    spilled = rows[over]
    ovf_cap = overflow.shape[0] // (wc + ovf_cols)
    q = tally[0] + torch.arange(spilled.shape[0], device=dest.device)
    keep = q < ovf_cap
    overflow[: ovf_cap * wc].view(ovf_cap, wc)[q[keep]] = spilled[keep, :wc]
    overflow[ovf_cap * wc :].view(ovf_cols, ovf_cap)[:, q[keep]] = \
        spilled[keep, wc : wc + ovf_cols].t()
    tally[0] += spilled.shape[0]


def route_pack_plain(hx, ctx_packed, counters, blocks, overflow, tally, *, size_bits: int,
                     wps: int, cap: int) -> None:
    """Plain K6, the source side of hop 1 (pack_dests of
    malva_tpu/parallel/sharded_index.py:326-347 over the source's lanes).
    ``hx`` is K1 hash-only's words with the context hash
    (:func:`callstep_hash_words`); each lane with a non-zero counter goes to
    the shard that owns its context word (``cw // wps``) as the row
    [context, counter, cw % wps, context bit, centre's Bloom word // wps],
    into ``blocks[d]`` (slot blocks of ``cap`` hop-1 rows, updated in place
    with their headers) or the overflow list; ``tally`` gets both counts."""
    D, wc = len(blocks), ctx_packed.shape[1]
    cw, cb = xxh3_mod_size(lanes(hx[0]), lanes(hx[1]), size_bits)
    bw = xxh3_mod_size(lanes(hx[2]), lanes(hx[3]), size_bits)[0]
    dest = torch.where(counters != 0, cw // wps, D)
    more = torch.stack([counters, (cw % wps).to(torch.int32), cb.to(torch.int32),
                        (bw // wps).to(torch.int32)], dim=1)
    _partition(dest, torch.cat([ctx_packed, more], dim=1), blocks, cap, wc, overflow, tally, 1)


def _check_route(name: str, blocks: list, cap: int, wc: int, cols: int, overflow, tally,
                 device) -> None:
    D = len(blocks)
    if not 1 <= D <= 16 or cap < 1:
        raise ValueError(f"{name}: 1 to 16 destinations and a capacity of 1 or more, got "
                         f"{D} and {cap}")
    for b in blocks:
        _check(b, torch.int32, f"{name} block")
        if b.device != device or b.numel() != slot_words(cap, wc, cols):
            raise ValueError(f"{name}: a block must be {slot_words(cap, wc, cols)} words on "
                             f"{device}")
    _check(overflow, torch.int32, "overflow")
    _check(tally, torch.int64, "tally")
    if (overflow.device != device or overflow.numel() % (wc + 1) or tally.device != device
            or tally.shape != (1 + 2 * D,)):
        raise ValueError(f"{name}: the overflow list must be rows of {wc + 1} words and the "
                         f"tally {1 + 2 * D} words, on {device}")


def route_scratch(device, D: int) -> torch.Tensor:
    """The scratch of K6's and K7's launches with ``D`` destinations on
    ``device`` (a ticket, a count of finished tiles and each tile's status
    per destination): made zeroed once; each launch leaves it zeroed, so
    launches in order on one stream may share it."""
    return torch.zeros(_build.library().malva_route_scratch_words(D), dtype=torch.int64,
                       device=device)


def _pointers(blocks: list):
    import ctypes

    return (ctypes.c_void_p * len(blocks))(*[b.data_ptr() for b in blocks])


def route_pack(hx, ctx_packed, counters, blocks, overflow, tally, *, size_bits: int, wps: int,
               cap: int, scratch=None) -> None:
    """K6: same effect as :func:`route_pack_plain`.  ``scratch`` is
    :func:`route_scratch`'s (made here when None)."""
    if not _on_cuda(hx, ctx_packed, counters, overflow, tally, *blocks):
        return route_pack_plain(hx, ctx_packed, counters, blocks, overflow, tally,
                                size_bits=size_bits, wps=wps, cap=cap)
    B, wc = ctx_packed.shape
    for t, name in ((hx, "hx"), (ctx_packed, "ctx_packed"), (counters, "counters")):
        _check(t, torch.int32, name)
    if hx.dim() != 2 or hx.shape[0] < 4 or hx.shape[1] != B or counters.shape != (B,):
        raise ValueError("route_pack: hx must be K1's (>= 4, B) words with the context hash")
    check_bloom_size(size_bits)
    if B > ROUTE_MAX_LANES:
        raise ValueError(f"route_pack: {B} lanes, more than one launch takes ({ROUTE_MAX_LANES})")
    _check_route("route_pack", blocks, cap, wc, HOP1_COLS, overflow, tally, ctx_packed.device)
    scratch = route_scratch(ctx_packed.device, len(blocks)) if scratch is None else scratch
    route_layout()
    _launch("malva_route_pack", ctx_packed.device, hx.data_ptr(), ctx_packed.data_ptr(),
            counters.data_ptr(), B, wc, size_bits, wps, len(blocks), _pointers(blocks), cap,
            overflow.data_ptr(), overflow.numel() // (wc + 1), tally.data_ptr(),
            scratch.data_ptr())
    LAUNCHES["route_pack"] += 1


def route_probe_plain(received, ctx_words, blocks, overflow, tally, *, wc: int, cap_in: int,
                      cap: int) -> None:
    """Plain K7, hop 1's owner: the live rows of the D hop-1 slot blocks
    in ``received`` (one tensor of D blocks of ``cap_in`` rows), in block
    and row order, each tested against the shard's context words, go to
    their Bloom-word owner as [context, counter, known] into ``blocks[d]``
    (``cap`` hop-2 rows each) or the overflow list (pack_dests of
    malva_tpu/parallel/sharded_index.py:383-394)."""
    D = len(blocks)
    got = torch.cat([slot_rows(b, cap_in, wc, HOP1_COLS)
                     for b in received.view(D, slot_words(cap_in, wc, HOP1_COLS))])
    lcw, cb = got[:, wc + 1].to(torch.int64), got[:, wc + 2].to(torch.int64)
    known = (lanes(ctx_words[lcw]) >> cb) & 1
    rows = torch.cat([got[:, : wc + 1], known.to(torch.int32)[:, None]], dim=1)
    _partition(got[:, wc + 3].to(torch.int64), rows, blocks, cap, wc, overflow, tally, 1 + D)


def route_probe(received, ctx_words, blocks, overflow, tally, *, wc: int, cap_in: int, cap: int,
                scratch=None) -> None:
    """K7: same effect as :func:`route_probe_plain`."""
    D = len(blocks)
    if not _on_cuda(received, ctx_words, overflow, tally, *blocks):
        return route_probe_plain(received, ctx_words, blocks, overflow, tally, wc=wc,
                                 cap_in=cap_in, cap=cap)
    _check(received, torch.int32, "received")
    _check(ctx_words, torch.int32, "ctx_words")
    if received.numel() != D * slot_words(cap_in, wc, HOP1_COLS):
        raise ValueError(f"route_probe: received must be {D} hop-1 blocks of {cap_in} rows")
    if D * cap_in > ROUTE_MAX_LANES:
        raise ValueError(f"route_probe: {D * cap_in} received rows, more than one launch takes "
                         f"({ROUTE_MAX_LANES})")
    _check_route("route_probe", blocks, cap, wc, HOP2_COLS, overflow, tally, received.device)
    scratch = route_scratch(received.device, D) if scratch is None else scratch
    route_layout()
    _launch("malva_route_probe", received.device, received.data_ptr(), cap_in, wc,
            ctx_words.data_ptr(), D, _pointers(blocks), cap, overflow.data_ptr(),
            overflow.numel() // (wc + 1), tally.data_ptr(), scratch.data_ptr())
    LAUNCHES["route_probe"] += 1


def shard_update_slots_plain(bf_packed, kmap_keys, state, slots, *, n_blocks: int, cap: int,
                             k: int, ref_k: int, size_bits: int, n_buckets: int, word_base: int,
                             counts_len: int, minifilter: bool) -> None:
    """Plain K4 slot entry: :func:`shard_update_plain` over the live rows
    of the ``n_blocks`` hop-2 slot blocks in ``slots``, in block and row
    order."""
    wc = (ref_k + 15) // 16
    got = torch.cat([slot_rows(b, cap, wc, HOP2_COLS)
                     for b in slots.view(n_blocks, slot_words(cap, wc, HOP2_COLS))])
    shard_update_plain(bf_packed, kmap_keys, state, got[:, :wc].contiguous(),
                       got[:, wc].contiguous(), got[:, wc + 1] != 0, k=k, ref_k=ref_k,
                       size_bits=size_bits, n_buckets=n_buckets, word_base=word_base,
                       counts_len=counts_len, minifilter=minifilter)


def shard_update_slots(bf_packed, kmap_keys, state, slots, *, n_blocks: int, cap: int, k: int,
                       ref_k: int, size_bits: int, n_buckets: int, word_base: int,
                       counts_len: int, minifilter: bool, events=None) -> None:
    """K4's slot entry: same effect as :func:`shard_update_slots_plain`,
    over the blocks' live rows alone, with no compaction pass and no host
    read of the headers."""
    args = (bf_packed, kmap_keys, state, slots)
    kw = dict(n_blocks=n_blocks, cap=cap, k=k, ref_k=ref_k, size_bits=size_bits,
              n_buckets=n_buckets, word_base=word_base, counts_len=counts_len,
              minifilter=minifilter)
    if not _on_cuda(*args):
        return shard_update_slots_plain(*args, **kw)
    for t, name in zip(args, ("bf_packed", "kmap_keys", "state", "slots")):
        _check(t, torch.int32, name)
    _check_lengths(k, ref_k)
    check_bloom_size(size_bits)
    wc = (ref_k + 15) // 16
    if (slots.numel() != n_blocks * slot_words(cap, wc, HOP2_COLS)
            or bf_packed.dim() != 2 or bf_packed.shape[1] != 2
            or kmap_keys.shape != (n_buckets, SLOTS * ((k + 15) // 16))
            or state.shape != (counts_len + n_buckets * SLOTS,) or n_blocks * cap >= 1 << 32
            or not 1 <= n_blocks <= 16):
        raise ValueError("shard_update_slots: array shapes do not match k, ref_k, n_buckets, "
                         "counts_len and the slot blocks (1 to 16 blocks, under 2^32 rows)")
    route_layout()
    _launch("malva_shard_update_slots", state.device, slots.data_ptr(), n_blocks, cap, wc, k,
            ref_k, bf_packed.data_ptr(), word_base, bf_packed.shape[0], kmap_keys.data_ptr(),
            state.data_ptr(), counts_len, n_buckets, size_bits, int(minifilter), events=events)
    LAUNCHES["shard_update"] += 1
    LAUNCHES["shard_update_slots"] += 1


# The plan of a whole routed step on CUDA: one int64 row per shard of
# pointers (as integers) and sizes, then the blocks each shard writes in
# hop 1 and in hop 2 ("max_dests" columns from "out1" and from "out2").
# csrc/route.cu owns the column order (PlanCol); :func:`route_layout` reads
# each column's index from the library by these names.
PLAN_NAMES = ("dev", "hx", "recv1", "recv2", "ovf", "ovf_cap", "tally", "counts", "ctx_words",
              "bf_packed", "n_words", "kmap_keys", "state", "ctx", "counters", "rows", "stream",
              "ev_hash0", "ev_hash1", "ev_upd0", "ev_upd1", "out1", "out2", "width", "max_dests")
_route_layout = None  # (the library, its plan columns), once checked


def route_layout():
    """The kernel library and the routed step's plan columns ({name:
    column} over PLAN_NAMES, "width" the row's width), read from the
    library, which owns their order; raises if the library lacks a column
    or lays out slot blocks otherwise than SLOT_HEAD, HOP1_COLS and
    HOP2_COLS here (``csrc/launch.cuh``), before any kernel of the route
    runs on them.  Checked once per loaded library."""
    global _route_layout
    lib = _build.library()
    if _route_layout is None or _route_layout[0] is not lib:
        slots = tuple(lib.malva_slot_layout(what) for what in range(3))
        if slots != (SLOT_HEAD, HOP1_COLS, HOP2_COLS):
            raise RuntimeError(f"the kernel library's slot blocks are (header, hop-1 columns, "
                               f"hop-2 columns) {slots}; ops/kernels.py has "
                               f"{(SLOT_HEAD, HOP1_COLS, HOP2_COLS)}")
        cols = {name: lib.malva_route_plan_col(name.encode()) for name in PLAN_NAMES}
        missing = [name for name, col in cols.items() if col < 0]
        if missing:
            raise RuntimeError(f"the kernel library's step plan has no column {missing}")
        _route_layout = (lib, cols)
    return _route_layout


def route_step(plan, *, wc: int, k: int, ref_k: int, size_bits: int, wps: int, cap: int,
               n_buckets: int, counts_len: int, minifilter: bool, copies: dict | None) -> None:
    """The routed step on CUDA in one C call (``csrc/route.cu
    malva_routed_step``): over the D shards of ``plan`` (a (D, width)
    int64 numpy array, see :func:`route_layout`), K1 hash-only and K6 on each source,
    hop 1's copies, K7 on each owner, hop 2's copies and K4's slot entry on
    each owner; each kernel's wrappers above are its single-launch form
    and plain version.  ``copies`` holds the ctypes arrays of the hops'
    card-to-card copies (``parallel/sharded_index.py Router``), or None
    where no pair of shards crosses cards.  Counts one launch of each
    kernel per shard."""
    import ctypes

    lib, cols = route_layout()
    D, width = plan.shape[0], cols["width"]
    if plan.shape != (D, width) or plan.dtype != "int64" or not plan.flags.c_contiguous:
        raise ValueError(f"route_step: the plan must be a contiguous ({D}, {width}) int64 array")
    c = copies or {"n": 0, "dev": None, "from": None, "to": None, "streams": None,
                   "hops": [dict.fromkeys(("produced", "copied", "dst", "src", "bytes"))] * 2}
    h1, h2 = c["hops"]
    err = lib.malva_routed_step(
        D, plan.ctypes.data_as(ctypes.c_void_p), wc, k, ref_k, int(minifilter), cap, size_bits,
        wps, n_buckets, counts_len, c["n"], c["dev"], c["from"], c["to"], c["streams"],
        h1["produced"], h2["produced"], h1["copied"], h2["copied"], h1["dst"], h1["src"],
        h2["dst"], h2["src"], h1["bytes"] or 0, h2["bytes"] or 0)
    if err != 0:
        raise RuntimeError(f"malva_routed_step: CUDA launch failed with error {err}")
    for name in ("callstep", "route_pack", "route_probe", "shard_update", "shard_update_slots"):
        LAUNCHES[name] += D


# -- K2: reference context scan ----------------------------------------------


def _window_cols(seq: torch.Tensor, n_pos: int, start: int, length: int):
    return [seq[start + j : start + j + n_pos].to(torch.int64) for j in range(length)]


def _canonical_cols(cols):
    """strcmp/RCN canonical form of per-position byte columns
    (pallas_kernels.py:198 _canonical_cols)."""
    rc = [complement(c.to(torch.uint8)).to(torch.int64) for c in reversed(cols)]
    keep = canonical_decision(cols, rc)
    return [torch.where(keep, a, b) for a, b in zip(cols, rc)]


def window_hash_plain(seq: torch.Tensor, n_pos: int, k: int, ref_k: int):
    """Plain K2 front end: (c_hi, c_lo, x_hi, x_lo) for the first n_pos
    windows of a uint8 sequence, as int64 lanes."""
    cols = _window_cols(seq, n_pos, 0, ref_k)
    off = (ref_k - k) // 2
    c = xxh3_64_cols(_canonical_cols(cols[off : off + k]))
    x = xxh3_64_cols(_canonical_cols(cols))
    return [*c, *x]


def _check_seq(seq: torch.Tensor, n_pos: int, ref_k: int) -> None:
    if seq.dim() != 1 or seq.shape[0] < n_pos + ref_k - 1:
        raise ValueError(f"seq must be 1-D with at least n_pos + ref_k - 1 = "
                         f"{n_pos + ref_k - 1} bytes, got shape {tuple(seq.shape)}")


def window_hash(seq: torch.Tensor, n_pos: int, k: int, ref_k: int):
    """K2 in hash-only mode; same outputs as :func:`window_hash_plain`."""
    _check_seq(seq, n_pos, ref_k)
    if not _on_cuda(seq):
        return window_hash_plain(seq, n_pos, k, ref_k)
    _check(seq, torch.uint8, "seq")
    _check_lengths(k, ref_k)
    out = torch.empty((4, n_pos), dtype=torch.int32, device=seq.device)
    _launch("malva_window_hash", seq.device, seq.data_ptr(), n_pos, k, ref_k, out.data_ptr())
    LAUNCHES["ref_scan"] += 1
    return [lanes(o) for o in out]


def ref_scan_plain(bf_words, ctx_words, seq, n_pos: int, *, k: int, ref_k: int,
                   size_bits: int) -> None:
    """Plain ref scan: for each of the first n_pos windows of ``seq``
    whose canonical center hits ``bf_words``, set the canonical window's
    bit in ``ctx_words`` (in place)."""
    c_hi, c_lo, x_hi, x_lo = window_hash_plain(seq, n_pos, k, ref_k)
    bw, bb = xxh3_mod_size(c_hi, c_lo, size_bits)
    hit = ((lanes(bf_words[bw]) >> bb) & 1).bool()
    cw, cb = xxh3_mod_size(x_hi, x_lo, size_bits)
    bloom_set(ctx_words, cw, cb, hit)


def ref_scan(bf_words, ctx_words, seq, n_pos: int, *, k: int, ref_k: int,
             size_bits: int) -> None:
    """K2: context scan of the first n_pos windows of a uint8 sequence
    (at least n_pos + ref_k - 1 bytes), OR-ing into ``ctx_words``."""
    _check_seq(seq, n_pos, ref_k)
    if not _on_cuda(bf_words, ctx_words, seq):
        return ref_scan_plain(bf_words, ctx_words, seq, n_pos, k=k, ref_k=ref_k,
                              size_bits=size_bits)
    _check(seq, torch.uint8, "seq")
    _check(bf_words, torch.int32, "bf_words")
    _check(ctx_words, torch.int32, "ctx_words")
    _check_lengths(k, ref_k)
    check_bloom_size(size_bits)
    if bf_words.shape != (size_bits // 32,) or ctx_words.shape != bf_words.shape:
        raise ValueError("ref_scan: Bloom word arrays do not match size_bits")
    _launch("malva_ref_scan", seq.device, seq.data_ptr(), n_pos, k, ref_k, bf_words.data_ptr(),
            ctx_words.data_ptr(), size_bits)
    LAUNCHES["ref_scan"] += 1


# -- K8 and K9: the sharded context scan ---------------------------------------
#
# A scan slot block: SLOT_HEAD header words ([rows, 0, 0, 0]), then W planes
# of cap words: each row a shard-local bit index, low word first (W = 1
# where a shard's bits fit in 32, else 2; scan_row_words).  The overflow
# list of ovf_cap rows: W planes, then the owner's plane.  A tally (int64):
# [rows appended to the overflow list, rows sent to each of the D owners].


def scan_row_words(wps: int) -> int:
    """Words of a scan row for shards of ``wps`` context words."""
    return 1 if wps * 32 <= 1 << 32 else 2


def scan_slot_words(cap: int, W: int) -> int:
    return SLOT_HEAD + cap * W


def scan_codes_plain(seq, n_pos: int, bf_words, *, k: int, ref_k: int, size_bits: int):
    """Plain codes of K8's scan half: for each of the first n_pos windows
    of ``seq``, the Bloom index of its canonical window where its canonical
    centre hits ``bf_words``, else -1 (int64)."""
    c_hi, c_lo, x_hi, x_lo = window_hash_plain(seq, n_pos, k, ref_k)
    bw, bb = xxh3_mod_size(c_hi, c_lo, size_bits)
    hit = ((lanes(bf_words[bw]) >> bb) & 1).bool()
    cw, cb = xxh3_mod_size(x_hi, x_lo, size_bits)
    return torch.where(hit, cw * 32 + cb, -1)


def scan_partition_plain(codes, blocks, overflow, tally, *, wps: int, cap: int) -> None:
    """Plain partition of K8 (``ScanRows``): each hit (code >= 0) goes to
    the owner of its context word, ``code // (32 * wps)``, as its
    shard-local bit index ``code - owner * 32 * wps`` in W words, into
    ``blocks[owner]`` (scan slot blocks of ``cap`` rows, updated in place
    with their headers) in position order, or to the overflow list with its
    owner; ``tally`` gets both counts."""
    D, W = len(blocks), scan_row_words(wps)
    dest = torch.where(codes >= 0, torch.clamp(codes // (32 * wps), max=D), D)
    local = codes - torch.clamp(dest, max=D - 1) * 32 * wps
    words = [storage(local & M32)] + ([storage(local >> 32)] if W == 2 else [])
    rows = torch.stack([*words, dest.to(torch.int32)], dim=1)
    _partition(dest, rows, blocks, cap, 0, overflow, tally, 1, slot_cols=W, ovf_cols=W + 1)


def scan_pack_plain(seq, n_pos: int, bf_words, blocks, overflow, tally, *, k: int, ref_k: int,
                    size_bits: int, wps: int, cap: int) -> None:
    """Plain K8: :func:`scan_codes_plain`, then :func:`scan_partition_plain`."""
    codes = scan_codes_plain(seq, n_pos, bf_words, k=k, ref_k=ref_k, size_bits=size_bits)
    scan_partition_plain(codes, blocks, overflow, tally, wps=wps, cap=cap)


def _check_scan(blocks: list, cap: int, W: int, overflow, tally, device) -> None:
    D = len(blocks)
    if not 1 <= D <= 16 or cap < 1:
        raise ValueError(f"scan_pack: 1 to 16 owners and a capacity of 1 or more, got {D} and "
                         f"{cap}")
    for b in blocks:
        _check(b, torch.int32, "scan_pack block")
        if b.device != device or b.numel() != scan_slot_words(cap, W):
            raise ValueError(f"scan_pack: a block must be {scan_slot_words(cap, W)} words on "
                             f"{device}")
    _check(overflow, torch.int32, "overflow")
    _check(tally, torch.int64, "tally")
    if (overflow.device != device or overflow.numel() % (W + 1) or tally.device != device
            or tally.shape != (1 + D,)):
        raise ValueError(f"scan_pack: the overflow list must be rows of {W + 1} words and the "
                         f"tally {1 + D} words, on {device}")


def scan_pack(seq, n_pos: int, bf_words, blocks, overflow, tally, *, k: int, ref_k: int,
              size_bits: int, wps: int, cap: int, scratch=None, prior=None) -> None:
    """K8: same effect as :func:`scan_pack_plain`, in one kernel launch
    that writes no per-position code (``csrc/ref_scan.cu``'s pack mode), on
    ``scratch`` (:func:`route_scratch`'s, made here when None).  With
    ``prior``, a pair (ctx_words, slots) of this shard's context words and
    the D scan slot blocks of ``cap`` rows it received in the previous
    chunk, the launch also sets their live rows in ctx_words, as
    :func:`scan_set` does (its prologue's rows)."""
    if n_pos > 0:
        _check_seq(seq, n_pos, ref_k)
    W, D = scan_row_words(wps), len(blocks)
    if prior is not None:
        ctx_words, slots = prior
        _check(ctx_words, torch.int32, "ctx_words")
        _check(slots, torch.int32, "slots")
        if slots.numel() != D * scan_slot_words(cap, W):
            raise ValueError(f"scan_pack: the prior slots must be {D} blocks of {cap} rows of "
                             f"{W} words")
    if not _on_cuda(seq, bf_words, overflow, tally, *blocks, *(prior or ())):
        if prior is not None:
            scan_set_plain(*prior, n_blocks=D, cap=cap, W=W)
        return scan_pack_plain(seq, n_pos, bf_words, blocks, overflow, tally, k=k, ref_k=ref_k,
                               size_bits=size_bits, wps=wps, cap=cap)
    _check(seq, torch.uint8, "seq")
    _check(bf_words, torch.int32, "bf_words")
    _check_lengths(k, ref_k)
    check_bloom_size(size_bits)
    if bf_words.shape != (size_bits // 32,):
        raise ValueError("scan_pack: the alt words do not match size_bits")
    _check_scan(blocks, cap, W, overflow, tally, seq.device)
    if prior is not None and any(t.device != seq.device for t in prior):
        raise ValueError(f"scan_pack: the prior's tensors must lie on {seq.device}")
    if n_pos > ROUTE_MAX_LANES:
        raise ValueError(f"scan_pack: {n_pos} positions, more than one launch takes "
                         f"({ROUTE_MAX_LANES})")
    dev = seq.device
    scratch = route_scratch(dev, len(blocks)) if scratch is None else scratch
    route_layout()
    set_ptr, ctx_ptr = (prior[1].data_ptr(), prior[0].data_ptr()) if prior else (None, None)
    _launch("malva_scan_pack", dev, seq.data_ptr(), n_pos, k, ref_k, bf_words.data_ptr(),
            size_bits, wps, W, D, _pointers(blocks), cap, overflow.data_ptr(),
            overflow.numel() // (W + 1), tally.data_ptr(), scratch.data_ptr(), set_ptr, ctx_ptr)
    LAUNCHES["scan_pack"] += 1


def scan_set_plain(ctx_words, slots, *, n_blocks: int, cap: int, W: int) -> None:
    """Plain K9: each live row of the ``n_blocks`` scan slot blocks in
    ``slots`` (a shard-local bit index) set in ``ctx_words``, in place."""
    got = torch.cat([slot_rows(b, cap, 0, W).to(torch.int64)
                     for b in slots.view(n_blocks, scan_slot_words(cap, W))])
    local = got[:, 0] & M32
    if W == 2:
        local = local | (got[:, 1] << 32)
    bloom_set(ctx_words, local >> 5, local & 31, torch.ones_like(local, dtype=torch.bool))


def scan_set(ctx_words, slots, *, n_blocks: int, cap: int, W: int) -> None:
    """K9: same effect as :func:`scan_set_plain`; one launch."""
    if not _on_cuda(ctx_words, slots):
        return scan_set_plain(ctx_words, slots, n_blocks=n_blocks, cap=cap, W=W)
    _check(ctx_words, torch.int32, "ctx_words")
    _check(slots, torch.int32, "slots")
    if W not in (1, 2) or cap < 1 or slots.numel() != n_blocks * scan_slot_words(cap, W):
        raise ValueError(f"scan_set: slots must be {n_blocks} blocks of {cap} rows of 1 or 2 "
                         f"words")
    _launch("malva_scan_set", ctx_words.device, slots.data_ptr(), n_blocks, cap, W,
            ctx_words.data_ptr())
    LAUNCHES["scan_set"] += 1


SCAN_PLAN_NAMES = ("dev", "stream", "seq", "n_pos", "bf_words", "ovf", "tally", "scratch", "set",
                   "ctx_words", "ev_pack0", "ev_pack1", "out", "width", "max_dests")
_scan_layout = None  # (the library, its scan plan columns), once checked


def scan_layout():
    """The kernel library and the scan step's plan columns ({name: column}
    over SCAN_PLAN_NAMES), read from the library, which owns their order;
    raises if the library lacks a column.  Checked once per loaded
    library."""
    global _scan_layout
    lib = route_layout()[0]
    if _scan_layout is None or _scan_layout[0] is not lib:
        cols = {name: lib.malva_scan_plan_col(name.encode()) for name in SCAN_PLAN_NAMES}
        missing = [name for name, col in cols.items() if col < 0]
        if missing:
            raise RuntimeError(f"the kernel library's scan plan has no column {missing}")
        _scan_layout = (lib, cols)
    return _scan_layout


def scan_step(plan, *, k: int, ref_k: int, size_bits: int, wps: int, W: int, cap: int,
              ovf_cap: int, copies: dict | None) -> None:
    """One chunk of the sharded context scan on CUDA in one C call
    (``csrc/route.cu malva_sharded_scan_step``): K8 on each shard of
    ``plan`` (a (D, width) int64 numpy array, see :func:`scan_layout`),
    whose prologue sets the rows the shard received in the previous chunk,
    then the slot blocks' copies between cards.  ``copies`` holds the
    ctypes arrays of the copies, with the chunk's "guard" and "done" events
    (``parallel/sharded_index.py ScanRouter``), or None where no pair of
    shards crosses cards.  Counts one launch of K8 per shard."""
    import ctypes

    lib, cols = scan_layout()
    D, width = plan.shape[0], cols["width"]
    if plan.shape != (D, width) or plan.dtype != "int64" or not plan.flags.c_contiguous:
        raise ValueError(f"scan_step: the plan must be a contiguous ({D}, {width}) int64 array")
    c = copies or dict.fromkeys(("dev", "from", "to", "streams", "produced", "guard", "done",
                                 "copied", "dst", "src"))
    err = lib.malva_sharded_scan_step(
        D, plan.ctypes.data_as(ctypes.c_void_p), k, ref_k, size_bits, wps, W, cap, ovf_cap,
        c.get("n", 0), c["dev"], c["from"], c["to"], c["streams"], c["produced"], c["guard"],
        c["done"], c["copied"], c["dst"], c["src"], c.get("bytes", 0))
    if err != 0:
        raise RuntimeError(f"malva_sharded_scan_step: CUDA launch failed with error {err}")
    LAUNCHES["scan_pack"] += D


# -- K3: sample counter front end --------------------------------------------


def _code_table(device) -> torch.Tensor:
    """Byte -> 2-bit code (A/a=0 C/c=1 G/g=2 T/t=3), 4 for any other byte."""
    table = torch.full((256,), 4, dtype=torch.int64, device=device)
    for code, (up, low) in enumerate((b"Aa", b"Cc", b"Gg", b"Tt")):
        table[up] = table[low] = code
    return table


def seq_pack_plain(seq: torch.Tensor, n_pos: int, ref_k: int):
    """Plain K3: for each of the first n_pos ref_k windows of a uint8
    sequence, ``(keys, valid)``.  ``valid`` (bool) is True iff every byte
    is A/C/G/T in either case; ``keys`` is (n_pos, ceil(ref_k/32)) int64
    holding the uint64 words of the canonical 2-bit key (pack_2bit
    layout), 0 for an invalid window.  Computed in 16-base words on int64
    lanes, since this torch cannot shift uint64."""
    table = _code_table(seq.device)
    n16 = (ref_k + 15) // 16
    fwd = [torch.zeros(n_pos, dtype=torch.int64, device=seq.device) for _ in range(n16)]
    rc = [torch.zeros_like(f) for f in fwd]
    valid = torch.ones(n_pos, dtype=torch.bool, device=seq.device)
    for j in range(ref_k):
        c = table[seq[j : j + n_pos].to(torch.int64)]
        valid &= c < 4
        c &= 3
        r = ref_k - 1 - j
        fwd[j // 16] |= c << (2 * (15 - j % 16))
        rc[r // 16] |= (3 - c) << (2 * (15 - r % 16))
    take_fwd = canonical_decision(fwd, rc)
    w32 = [torch.where(take_fwd, f, b) for f, b in zip(fwd, rc)]
    if n16 % 2:
        w32.append(torch.zeros_like(w32[0]))
    # hi * 2^32 on the signed reading of hi sets bit 63 without overflow
    cols = [((w32[2 * i] ^ 0x80000000) - 0x80000000) * (1 << 32) | w32[2 * i + 1]
            for i in range(len(w32) // 2)]
    keys = torch.stack(cols, dim=1)
    return torch.where(valid[:, None], keys, 0), valid


def seq_pack(seq: torch.Tensor, n_pos: int, ref_k: int):
    """K3: ``(keys, valid)`` of the first n_pos windows of a uint8 read
    chunk (at least n_pos + ref_k - 1 bytes); see :func:`seq_pack_plain`."""
    _check_seq(seq, n_pos, ref_k)
    if not _on_cuda(seq):
        return seq_pack_plain(seq, n_pos, ref_k)
    _check(seq, torch.uint8, "seq")
    _check_lengths(1, ref_k)
    keys = torch.empty((n_pos, (ref_k + 31) // 32), dtype=torch.int64, device=seq.device)
    valid = torch.empty(n_pos, dtype=torch.bool, device=seq.device)
    _launch("malva_seq_pack", seq.device, seq.data_ptr(), n_pos, ref_k, keys.data_ptr(),
            valid.data_ptr())
    LAUNCHES["seq_pack"] += 1
    return keys, valid
