"""The five hand-written kernels of the device paths, their wrappers and
their plain PyTorch versions.

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

* K5 ``gather_update`` (``csrc/shard_step.cu``) has no Pallas counterpart:
  it replaces the XLA body of the all-gather sharded step
  (``malva_tpu/parallel/sharded_index.py:141-183``), run on every shard
  over the whole gathered batch.  It is K1's template with a third policy:
  a lane is live where its Bloom word or one of its global buckets is the
  shard's, its row is gathered only for the first, and the probe skips a
  bucket of another shard without reading it.

``callstep_hash`` / ``window_hash`` are the kernels' hash-only modes,
which write exactly the TPU kernels' outputs so the card can check them
against the TPU kernels' contract.

Device arrays are int32 tensors holding uint32 bit patterns (ops.bloom).
Hash-only outputs are returned as int64 lanes in [0, 2^32).

The call-step wrappers (``callstep``, ``callstep_hash``, ``shard_update``,
``gather_update``) take ``events=(start, stop)``, two
``torch.cuda.Event(enable_timing=True)``; the C launcher records them on
the launch stream just before and after the kernel, inside the one ctypes
call that holds no GIL, so their elapsed time is the kernel's device time
(``csrc/launch.cuh``).
"""

from __future__ import annotations

import torch

from ..index.kmap_table import SLOTS, probe_bucket_table
from . import _build
from .bloom import bloom_set, lanes, scatter_add_u32
from .packed import canonical_center, decode_byte_cols, popcount32
from .seq import canonical_decision, complement
from .xxh3 import check_bloom_size, xxh3_64_cols, xxh3_mod_size

LAUNCHES = {"callstep": 0, "ref_scan": 0, "seq_pack": 0, "shard_update": 0, "gather_update": 0}
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


_TIMED = ("malva_callstep", "malva_callstep_hash", "malva_shard_update", "malva_gather_update")


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
    return [lanes(o) for o in out]


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


def gather_update_plain(bf_packed, kmap_keys, state, ctx_packed, counters, known, *, k: int,
                        ref_k: int, size_bits: int, n_buckets: int, word_base: int,
                        bucket_base: int, counts_len: int) -> None:
    """Plain K5 over one shard, updating ``state`` in place: the body of
    malva_tpu/parallel/sharded_index.py:128-185 (make_sharded_call_step).

    ``bf_packed`` is the shard's (W/S, 2) [word, local rank] rows (no
    mini-filter) for global words ``word_base ..``, ``kmap_keys`` its
    (nbps, SLOTS * w_k) slice of the global bucket table of ``n_buckets``,
    buckets ``bucket_base ..``, and ``state`` its ``[bf_counts (counts_len)
    | kmap_vals (nbps * SLOTS)]``.  Every lane of the gathered batch
    (packed context, counter, ``known``: the context-filter flags OR-merged
    over the shards) adds its counter to the rank counter of its centre's
    Bloom bit when the word is this shard's, the bit is set and the context
    is not known (JAX ``:152-163``), and to the exact-map slot of its
    centre where one of its global buckets is this shard's and holds it,
    gated neither by the bit nor by ``known`` (JAX ``:169-183``)."""
    words = [lanes(ctx_packed[:, j]) for j in range(ctx_packed.shape[1])]
    can = canonical_center(words, k, ref_k)
    c_hi, c_lo = xxh3_64_cols(decode_byte_cols(can, k))
    bw, bb = xxh3_mod_size(c_hi, c_lo, size_bits)
    lw = bw - word_base
    mine = (lw >= 0) & (lw < bf_packed.shape[0])
    row = lanes(bf_packed[torch.where(mine, lw, 0)])
    word, rank = row[:, 0], row[:, 1]
    is_set = ((word >> bb) & 1).bool()
    cnt_idx = rank + popcount32(word & ((1 << bb) - 1))
    scatter_add_u32(state, cnt_idx, counters, mine & is_set & ~known)
    slot, found = probe_bucket_table(kmap_keys, n_buckets, (k + 15) // 16, can, c_hi, c_lo,
                                     base=bucket_base)
    scatter_add_u32(state, counts_len + slot, counters, found)


def gather_update(bf_packed, kmap_keys, state, ctx_packed, counters, known, *, k: int,
                  ref_k: int, size_bits: int, n_buckets: int, word_base: int, bucket_base: int,
                  counts_len: int, events=None) -> None:
    """K5: the shard side of the all-gather step on one shard; same effect
    as :func:`gather_update_plain`.  ``known`` is a bool tensor."""
    args = (bf_packed, kmap_keys, state, ctx_packed, counters, known)
    kw = dict(k=k, ref_k=ref_k, size_bits=size_bits, n_buckets=n_buckets, word_base=word_base,
              bucket_base=bucket_base, counts_len=counts_len)
    if not _on_cuda(*args):
        return gather_update_plain(*args, **kw)
    for t, name in zip(args[:5], ("bf_packed", "kmap_keys", "state", "ctx_packed", "counters")):
        _check(t, torch.int32, name)
    _check(known, torch.bool, "known")
    _check_lengths(k, ref_k)
    check_bloom_size(size_bits)
    B, wc = ctx_packed.shape
    nbps = kmap_keys.shape[0]
    if (wc != (ref_k + 15) // 16 or counters.shape != (B,) or known.shape != (B,)
            or bf_packed.dim() != 2 or bf_packed.shape[1] != 2
            or kmap_keys.shape != (nbps, SLOTS * ((k + 15) // 16))
            or not 0 <= bucket_base <= n_buckets - nbps
            or state.shape != (counts_len + nbps * SLOTS,) or B >= 1 << 32):
        raise ValueError("gather_update: array shapes do not match k, ref_k, n_buckets, "
                         "bucket_base and counts_len (or 2^32 lanes or more)")
    _launch("malva_gather_update", state.device, ctx_packed.data_ptr(), counters.data_ptr(),
            known.data_ptr(), B, wc, k, ref_k, bf_packed.data_ptr(), word_base,
            bf_packed.shape[0], kmap_keys.data_ptr(), state.data_ptr(), counts_len, n_buckets,
            bucket_base, nbps, size_bits, events=events)
    LAUNCHES["gather_update"] += 1


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
