"""Streaming sample k-mer counting — the KMC replacement — on the host or
with the sort-count on a torch device.

Reproduces the *effective* contract the reference consumes from a
default-flags KMC run (reference: MALVA:107 `kmc -m4 -k<refk> -t1 -fm`,
consumed at main.cpp:488-500): the distinct **canonical** ref_k-mers of
the read set, restricted to windows of pure A/C/G/T (KMC skips k-mers
containing any other symbol), with k-mers occurring fewer than ``ci``
times excluded (KMC default ci=2) and counters saturated at ``cs`` (KMC
default cs=255).  Counting is exact two-stage (count -> threshold/cap),
because the ci/cs effects are not linear.

The host path is the port's copy of ``malva_tpu/count/counter.py``: it
packs canonical k-mers 2 bits a base and counts by sort + run-length over
uint64 word columns, merging chunks so that memory stays bounded.

With a device, it runs the JAX package's device read loop
(``counter.py:284-322``, flush ``:255-267``): reads of at least ref_k
bases are joined by 0xFF separators, the block is cut into pieces of
``chunk_kmers`` windows that overlap by ref_k - 1 bytes, and each piece's
distinct runs from the device step (K3 and a torch sort,
``device_count.py``) are merged into the accumulator on the host.  K3
reads lowercase bases as uppercase, so the reads cross as they are.  The
power-of-two step sizes of the TPU version (they bound XLA recompiles)
and the checkpoint are not carried over: the first has no use under
torch, and ``call`` does not take the second.
"""

from __future__ import annotations

import sys

import numpy as np

from ..io.fasta import iter_read_batches
from ..ops.seq import CODE_TABLE, canonical, pack_2bit, unpack_2bit, upper
from ..utils.errors import InputError

SEP = b"\xff"  # read separator: any window across it is not pure ACGT


def _windows_of_read(seq: bytes, k: int) -> np.ndarray:
    """All pure-ACGT k-windows of one read as (n, k) uint8 (uppercased)."""
    a = upper(np.frombuffer(seq, dtype=np.uint8))
    if len(a) < k:
        return np.zeros((0, k), dtype=np.uint8)
    win = np.lib.stride_tricks.sliding_window_view(a, k)
    valid_base = CODE_TABLE[a] != 255
    # window valid iff all k bases valid: prefix-sum trick
    cs = np.concatenate([[0], np.cumsum(valid_base)])
    ok = (cs[k:] - cs[:-k]) == k
    return win[ok]


def _sorted_counts(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sort (N, W) uint64 rows lexicographically and run-length count."""
    if packed.shape[0] == 0:
        return packed, np.zeros(0, dtype=np.int64)
    if packed.shape[1] <= 2:
        from ..utils import native

        out = native.sort_count(packed)
        if out is not None:
            return out
    order = np.lexsort(tuple(packed[:, w] for w in range(packed.shape[1] - 1, -1, -1)))
    s = packed[order]
    diff = np.any(s[1:] != s[:-1], axis=1)
    starts = np.concatenate([[0], np.nonzero(diff)[0] + 1])
    ends = np.concatenate([starts[1:], [s.shape[0]]])
    return s[starts], (ends - starts).astype(np.int64)


def _merge_runs(
    keys_a: np.ndarray, cnt_a: np.ndarray, keys_b: np.ndarray, cnt_b: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Merge two sorted distinct-key runs, summing counts."""
    if keys_a.shape[0] == 0:
        return keys_b, cnt_b
    if keys_b.shape[0] == 0:
        return keys_a, cnt_a
    if keys_a.shape[1] <= 2:
        from ..utils import native

        out = native.merge_runs(keys_a, cnt_a, keys_b, cnt_b)
        if out is not None:
            return out
    keys = np.concatenate([keys_a, keys_b])
    cnts = np.concatenate([cnt_a, cnt_b])
    order = np.lexsort(tuple(keys[:, w] for w in range(keys.shape[1] - 1, -1, -1)))
    keys = keys[order]
    cnts = cnts[order]
    diff = np.any(keys[1:] != keys[:-1], axis=1)
    starts = np.concatenate([[0], np.nonzero(diff)[0] + 1])
    summed = np.add.reduceat(cnts, starts)
    return keys[starts], summed


def _parse_dump_block(block: bytes, ref_k: int) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized parse of whole lines of ``KMER<ws>COUNT``.  The k-mer
    column is fixed-width (ref_k), so lines are validated by checking the
    byte at offset ref_k is whitespace; counts are parsed positionally
    (digit-by-digit over the block, <= 10 iterations)."""
    a = np.frombuffer(block, dtype=np.uint8)
    nl = np.nonzero(a == 0x0A)[0]
    starts = np.concatenate([[0], nl[:-1] + 1]) if nl.size else np.zeros(0, np.int64)
    ends = nl  # exclusive of the newline
    lens = ends - starts
    nonempty = lens > 0
    starts, ends, lens = starts[nonempty], ends[nonempty], lens[nonempty]
    if starts.size == 0:
        return np.zeros((0, ref_k), np.uint8), np.zeros(0, np.uint32)
    sep = a[np.minimum(starts + ref_k, a.shape[0] - 1)]
    bad = (lens <= ref_k) | ((sep != 0x09) & (sep != 0x20))
    if bad.any():
        i = int(np.nonzero(bad)[0][0])
        line = block[starts[i] : ends[i]]
        tok = line.split()[0] if line.split() else b""
        raise InputError(f"kmc dump k-mer length {len(tok)} != ref_k {ref_k}")
    kmers = upper(a[starts[:, None] + np.arange(ref_k)])
    # positional integer parse of the count field (stops at any non-digit,
    # so trailing \r is harmless)
    cstart = starts + ref_k + 1
    counts = np.zeros(starts.shape[0], dtype=np.uint64)
    alive = np.ones(starts.shape[0], dtype=bool)
    for j in range(20):
        p = cstart + j
        inb = p < ends
        d = np.where(inb, a[np.minimum(p, a.shape[0] - 1)], np.uint8(0))
        is_digit = (d >= 0x30) & (d <= 0x39)
        alive = alive & inb & is_digit
        if not alive.any():
            break
        counts = np.where(alive, counts * 10 + (d - 0x30), counts)
    return kmers, counts.astype(np.uint32)


def iter_kmc_dump(path: str, ref_k: int, chunk_bytes: int = 1 << 26):
    """Stream a `kmc_dump` text file (``KMER<TAB>COUNT`` per line) as
    ((M, ref_k) uint8, (M,) uint32) batches of ~chunk_bytes each — a WGS
    dump is tens of GB and must never materialize whole (the reference
    consumes the same data incrementally through the KMC API,
    main.cpp:488)."""
    import gzip

    op = gzip.open if path.endswith(".gz") else open
    carry = b""
    with op(path, "rb") as f:
        while True:
            block = f.read(chunk_bytes)
            if not block:
                break
            block = carry + block
            cut = block.rfind(b"\n") + 1
            carry = block[cut:]
            if cut:
                yield _parse_dump_block(block[:cut], ref_k)
    if carry:
        yield _parse_dump_block(carry + b"\n", ref_k)


def load_kmc_dump(path: str, ref_k: int) -> tuple[np.ndarray, np.ndarray]:
    """Whole-file convenience wrapper over :func:`iter_kmc_dump`."""
    ks, cs = [], []
    for k_arr, c_arr in iter_kmc_dump(path, ref_k):
        ks.append(k_arr)
        cs.append(c_arr)
    if not ks:
        return np.zeros((0, ref_k), np.uint8), np.zeros(0, np.uint32)
    return np.concatenate(ks), np.concatenate(cs)


def _native_reads_available(ref_k: int) -> bool:
    """The fused native window->packed-canonical kernel covers ref_k<=64
    (keys of at most two u64 words)."""
    from ..utils import native

    return ref_k <= 64 and native.load() is not None


def _host_chunk_runs(batches, ref_k: int, chunk_kmers: int, flush_each_batch: bool = False):
    """The host counter's chunk loop: sorted distinct (keys_u64, counts)
    runs of the read batches, one per flush of about ``chunk_kmers``
    windows, with ``None`` after each batch as :func:`iter_device_runs`
    (everything before it flushed when ``flush_each_batch`` is set).  The
    native path packs raw reads straight to canonical keys; without the
    library, the windows go through numpy."""
    native_reads = _native_reads_available(ref_k)
    pending: list = []
    pending_n = 0

    def flush():
        nonlocal pending, pending_n
        if not pending:
            return
        if native_reads:
            from ..utils import native

            # fused native path: raw read bytes -> packed canonical keys
            # (no (windows, k) byte matrix ever materializes); the packed
            # buffer is disposable, so the sort consumes it in place and
            # the run views die at the merge — no working/output copies
            packed = native.read_kmers(pending, ref_k)
            pending, pending_n = [], 0
            out = native.sort_count_inplace(packed)
            yield out if out is not None else _sorted_counts(packed)
            return
        block = np.concatenate(pending, axis=0)
        pending, pending_n = [], 0
        yield _sorted_counts(pack_2bit(canonical(block)))

    for batch in batches:
        for seq in batch:
            if native_reads:
                if len(seq) >= ref_k:
                    pending.append(seq)
                    pending_n += len(seq) - ref_k + 1  # upper bound
            else:
                w = _windows_of_read(seq, ref_k)
                if w.shape[0]:
                    pending.append(w)
                    pending_n += w.shape[0]
            if pending_n >= chunk_kmers:
                yield from flush()
        if flush_each_batch:
            yield from flush()
        yield None
    yield from flush()


def iter_device_runs(batches, ref_k: int, chunk_kmers: int, device,
                     flush_each_batch: bool = False, stats=None):
    """Sorted distinct (keys_u64, counts) runs of the read batches, one
    per device piece of ``chunk_kmers`` windows.  A piece is cut short
    only at the end, or at a batch end with ``flush_each_batch``; else
    the windows past the last full piece carry over into the next block.
    After each batch it yields ``None``, everything before it flushed
    when ``flush_each_batch`` is set, so a caller can commit there.  Each
    piece's parts go to ``stats`` (``count/stats.py CountStats``) if given."""
    from .device_count import device_seq_sorted_counts, make_seq_sort_count_step

    step = make_seq_sort_count_step(ref_k, chunk_kmers, device, stats)
    pending: list[bytes] = []
    pending_n = 0  # bytes, separators included

    def flush(whole: bool):
        nonlocal pending, pending_n
        block = bytearray().join(pending)  # writable: no copy on the way to torch
        n_pos = len(block) - ref_k + 1
        n_pieces = -(-n_pos // chunk_kmers) if whole else n_pos // chunk_kmers
        arr = np.frombuffer(block, dtype=np.uint8)
        for start in range(0, max(n_pieces, 0) * chunk_kmers, chunk_kmers):
            yield device_seq_sorted_counts(step, arr[start : start + chunk_kmers + ref_k - 1])
        rest = b"" if whole else bytes(block[n_pieces * chunk_kmers :])
        pending, pending_n = ([rest], len(rest)) if rest else ([], 0)

    for batch in batches:
        for seq in batch:
            if len(seq) >= ref_k:
                pending += (seq, SEP)
                pending_n += len(seq) + 1
                if pending_n - ref_k + 1 >= chunk_kmers:
                    yield from flush(whole=False)
        if flush_each_batch and pending:
            yield from flush(whole=True)
        yield None
    if pending:
        yield from flush(whole=True)


def count_reads_kmers(reads_path: str, ref_k: int, ci: int = 2, cs: int = 255,
                      chunk_kmers: int = 1 << 25, log=None, device=None,
                      return_packed: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Distinct canonical ref_k-mers of a FASTA/FASTQ file with
    ``ci <= count``, counts saturated at ``cs``: (M, ref_k) uint8 ASCII
    rows, or the 2-bit packed (M, ceil(ref_k/32)) uint64 rows with
    ``return_packed`` (the call step consumes those directly,
    ``index.device.packed64_to_u32``).  The sort-count runs on ``device``
    when one is given, else on the host.  The summary line goes to ``log``
    (stderr as it is at the call)."""
    log = sys.stderr if log is None else log
    acc_keys = np.zeros((0, (ref_k + 31) // 32), dtype=np.uint64)
    acc_cnts = np.zeros(0, dtype=np.int64)
    batches = iter_read_batches(reads_path)
    runs = (_host_chunk_runs(batches, ref_k, chunk_kmers) if device is None
            else iter_device_runs(batches, ref_k, chunk_kmers, device))
    for run in runs:
        if run is not None:
            acc_keys, acc_cnts = _merge_runs(acc_keys, acc_cnts, *run)
    total_windows = int(acc_cnts.sum())
    keep = acc_cnts >= ci
    keys = acc_keys[keep]
    counts = np.minimum(acc_cnts[keep], cs).astype(np.uint32)
    where = "" if device is None else f" (sort-count on {device})"
    print(f"[malva-tpu-torch/count] {total_windows} k-mer occurrences, {acc_cnts.shape[0]} "
          f"distinct, {keys.shape[0]} past ci={ci}{where}", file=log)
    return (keys if return_packed else unpack_2bit(keys, ref_k)), counts
