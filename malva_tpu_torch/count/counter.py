"""Sample k-mer counting with the sort-count on a torch device.

Counterpart of ``malva_tpu.count.counter.count_reads_kmers``.  Without a
device it is that function (the native host counter).  With one, it runs
the JAX package's device read loop (``counter.py:284-322``, flush
``:255-267``): reads of at least ref_k bases are joined by 0xFF
separators, the block is cut into pieces of ``chunk_kmers`` windows
that overlap by ref_k - 1 bytes, and each piece's distinct runs from the
device step are merged into the accumulator on the host.  K3 reads
lowercase bases as uppercase, so the reads cross as they are.  The
power-of-two step sizes of the TPU version (they bound XLA recompiles)
and the checkpoint are not carried over: the first has no use under
torch, and ``call`` does not take the second.
"""

from __future__ import annotations

import sys

import numpy as np

from malva_tpu.count import counter as host_counter
from malva_tpu.count.counter import _merge_runs, iter_read_batches
from malva_tpu.ops.seq import unpack_2bit

from .device_count import device_seq_sorted_counts, make_seq_sort_count_step

SEP = b"\xff"  # read separator: any window across it is not pure ACGT


def iter_device_runs(batches, ref_k: int, chunk_kmers: int, device,
                     flush_each_batch: bool = False):
    """Sorted distinct (keys_u64, counts) runs of the read batches, one
    per device piece of ``chunk_kmers`` windows.  A piece is cut short
    only at the end, or at a batch end with ``flush_each_batch``; else
    the windows past the last full piece carry over into the next block.
    After each batch it yields ``None``, everything before it flushed
    when ``flush_each_batch`` is set, so a caller can commit there."""
    step = make_seq_sort_count_step(ref_k, chunk_kmers, device)
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
    ``ci <= count``, counts saturated at ``cs``; ASCII rows, or the 2-bit
    packed (M, ceil(ref_k/32)) uint64 rows with ``return_packed``.  The
    summary line goes to ``log`` (stderr as it is at the call)."""
    log = sys.stderr if log is None else log
    if device is None:
        return host_counter.count_reads_kmers(reads_path, ref_k, ci=ci, cs=cs,
                                              chunk_kmers=chunk_kmers, log=log,
                                              return_packed=return_packed)
    acc_keys = np.zeros((0, (ref_k + 31) // 32), dtype=np.uint64)
    acc_cnts = np.zeros(0, dtype=np.int64)
    for run in iter_device_runs(iter_read_batches(reads_path), ref_k, chunk_kmers, device):
        if run is not None:
            acc_keys, acc_cnts = _merge_runs(acc_keys, acc_cnts, *run)
    total_windows = int(acc_cnts.sum())
    keep = acc_cnts >= ci
    keys = acc_keys[keep]
    counts = np.minimum(acc_cnts[keep], cs).astype(np.uint32)
    print(f"[malva-tpu-torch/count] {total_windows} k-mer occurrences, {acc_cnts.shape[0]} "
          f"distinct, {keys.shape[0]} past ci={ci} (sort-count on {device})", file=log)
    return (keys if return_packed else unpack_2bit(keys, ref_k)), counts
