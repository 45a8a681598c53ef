"""Bounded-memory sample counting with the sort-count on a torch device.

Counterpart of ``malva_tpu.count.spill.count_reads_kmers_spill``.  Without
a device it is that function.  With one, it runs the JAX package's
producer loop (``spill.py:235-375``) with the device flush of
``:309-319``: each device piece's distinct runs become one segment of
``malva_tpu``'s ``SpillStore``, the manifest is committed at every read
batch boundary (so an interrupted count resumes there), and the result
streams out of ``SpillStore.iter_merged`` bucket by bucket.
"""

from __future__ import annotations

import json
import os
import sys

from malva_tpu.count import spill as host_spill
from malva_tpu.count.counter import iter_read_batches
from malva_tpu.count.spill import SpillStore

from .counter import iter_device_runs

TAG = "[malva-tpu-torch/spill]"


def count_reads_kmers_spill(reads_path: str, ref_k: int, spill_dir: str, ci: int = 2,
                            cs: int = 255, chunk_kmers: int = 1 << 23, n_buckets: int = 1024,
                            log=None, device=None, resume: bool = True,
                            keep_spill: bool = False):
    """An iterator of (keys_u64, counts_u32) batches, one per spill bucket,
    whose union is the in-RAM counter's result.  Progress goes to ``log``
    (stderr as it is at the call)."""
    log = sys.stderr if log is None else log
    if device is None:
        return host_spill.count_reads_kmers_spill(
            reads_path, ref_k, spill_dir, ci=ci, cs=cs, chunk_kmers=chunk_kmers,
            n_buckets=n_buckets, log=log, resume=resume, keep_spill=keep_spill)
    store = SpillStore(spill_dir, n_buckets)
    manifest_path = os.path.join(spill_dir, "manifest.json")
    start_batch = total_windows = 0
    produced = False
    if resume and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            man = json.load(f)
        if man.get("ref_k") == ref_k and man.get("reads_path") == reads_path:
            start_batch = int(man["batch"])
            total_windows = int(man["windows"])
            produced = bool(man.get("done"))
            store.drop_segments_from(int(man["n_seg"]))
            print(f"{TAG} " + ("spill complete: skipping production" if produced else
                               f"resuming at batch {start_batch} ({store.n_seg} segments "
                               f"committed)"), file=log)
        else:
            print(f"{TAG} manifest mismatch, restarting", file=log)
            store.cleanup()
    else:
        store.cleanup()

    def commit_manifest(batch_i: int, done: bool = False) -> None:
        tmp = manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"ref_k": ref_k, "reads_path": reads_path, "batch": batch_i,
                       "n_seg": store.n_seg, "windows": total_windows, "done": done}, f)
        os.replace(tmp, manifest_path)

    if not produced:
        batches = (b for i, b in enumerate(iter_read_batches(reads_path)) if i >= start_batch)
        batch_i = start_batch
        for run in iter_device_runs(batches, ref_k, chunk_kmers, device, flush_each_batch=True):
            if run is None:  # batch boundary: everything flushed is committed
                batch_i += 1
                commit_manifest(batch_i)
            elif run[0].shape[0]:
                total_windows += int(run[1].sum())
                store.add_segment(*run)
        commit_manifest(batch_i, done=True)
    print(f"{TAG} {total_windows} k-mer occurrences in {store.n_seg} segments; merging "
          f"{n_buckets} buckets (sort-count on {device})", file=log)

    def merged():
        n_out = 0
        for keys, cnts in store.iter_merged(ci, cs):
            n_out += keys.shape[0]
            yield keys, cnts
        print(f"{TAG} {n_out} distinct k-mers past ci={ci}", file=log)
        if not keep_spill:
            store.cleanup()

    return merged()
