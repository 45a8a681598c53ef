"""Bounded-memory k-mer counting via disk spill — `kmc -m4` parity — on the
host or with the sort-count on a torch device.

The port's copy of ``malva_tpu/count/spill.py``; with a device, each
device piece's distinct runs (``counter.iter_device_runs``) become one
segment, as in the JAX package's device flush (``spill.py:309-319``).

The in-RAM counter (count.counter) keeps every distinct canonical
ref_k-mer in host memory: fine up to cohort scale, impossible for a 30x
whole-genome read set (billions of distinct keys, mostly error
singletons).  The reference sidesteps this by shelling out to KMC with a
4 GB budget and disk spill (reference: MALVA:107 `kmc -m4`); this module
is the built-in equivalent:

1. **Distribute**: reads stream through the existing chunk counter
   (canonicalize + pack + sort + run-length — device or host), and each
   chunk's sorted distinct (key, count) runs are partitioned by a
   multiplicative hash of the packed key into N_BUCKETS spill buckets,
   written as one segment file trio per flush (keys/counts/offsets .npy,
   committed atomically via rename).
2. **Merge**: per bucket, the slices of every segment are mmap-loaded,
   concatenated, sorted, and run-length-summed; ci/cs apply per bucket.
   Peak RAM is O(total_spilled / N_BUCKETS), independent of the genome.

The result streams out bucket by bucket (an iterator of
(keys_u64, counts) batches) so the full distinct set never materializes
in RAM either — the call phase feeds the batches straight into the
device step.

Checkpoint/resume: a manifest (json, atomic rename) records the number
of committed segments and the read-batch cursor, advanced only at read
batch boundaries; on resume, segment files beyond the manifest count are
deleted (they came from a partially processed batch) and streaming
restarts at the cursor.  Batch segmentation is deterministic, so a
resumed count is byte-identical to a clean one.
"""

from __future__ import annotations

import json
import os
import sys
from contextlib import nullcontext

import numpy as np

from ..io.fasta import iter_read_batches
from .counter import _host_chunk_runs, iter_device_runs

TAG = "[malva-tpu-torch/spill]"

# multiplicative spill-bucket hash over the packed words (canonical
# k-mers are NOT uniform in their prefix — never partition by raw bits)
_MIX = (np.uint64(0x9E3779B97F4A7C15), np.uint64(0xC2B2AE3D27D4EB4F),
        np.uint64(0x165667B19E3779F9), np.uint64(0x27D4EB2F165667C5))


def _bucket_of(keys_u64: np.ndarray, n_buckets: int) -> np.ndarray:
    if n_buckets <= 1:  # a 64-bit shift is platform-undefined
        return np.zeros(keys_u64.shape[0], dtype=np.int64)
    h = np.zeros(keys_u64.shape[0], dtype=np.uint64)
    for j in range(keys_u64.shape[1]):
        h ^= keys_u64[:, j] * _MIX[j % len(_MIX)]
    h *= _MIX[0]
    return (h >> np.uint64(64 - int(n_buckets).bit_length() + 1)).astype(np.int64)


class SpillStore:
    """Segmented on-disk (key, count) run store, partitioned by bucket."""

    def __init__(self, dirpath: str, n_buckets: int = 1024):
        assert n_buckets & (n_buckets - 1) == 0
        self.dir = dirpath
        self.n_buckets = n_buckets
        self.n_seg = 0
        os.makedirs(dirpath, exist_ok=True)

    def _seg_paths(self, i: int):
        return (os.path.join(self.dir, f"seg{i:06d}.keys.npy"),
                os.path.join(self.dir, f"seg{i:06d}.cnts.npy"),
                os.path.join(self.dir, f"seg{i:06d}.offs.npy"))

    def add_segment(self, keys: np.ndarray, cnts: np.ndarray) -> None:
        """Partition one chunk's distinct runs by bucket and commit as a
        segment (atomic: tmp files + rename, offsets last)."""
        from ..utils import native

        part = native.bucket_partition(keys, cnts, self.n_buckets)
        if part is not None:  # one native O(n) stable scatter
            keys, cnts, offs = part
        else:
            b = _bucket_of(keys, self.n_buckets)
            order = np.argsort(b, kind="stable")
            keys = keys[order]
            cnts = np.asarray(cnts)[order].astype(np.uint32)
            offs = np.zeros(self.n_buckets + 1, dtype=np.int64)
            np.add.at(offs, b + 1, 1)
            offs = np.cumsum(offs)
        pk, pc, po = self._seg_paths(self.n_seg)
        for path, arr in [(pk, keys), (pc, cnts), (po, offs)]:
            np.save(path + ".tmp.npy", arr)
            os.replace(path + ".tmp.npy", path)
        self.n_seg += 1

    def drop_segments_from(self, n: int) -> None:
        i = n
        while True:
            paths = self._seg_paths(i)
            if not any(os.path.exists(p) for p in paths):
                break
            for p in paths:
                if os.path.exists(p):
                    os.remove(p)
            i += 1
        self.n_seg = n

    # Records held in RAM at once during the merge (per bucket-GROUP, see
    # iter_merged).  16B/record u64-pair keys + 4B counts -> ~320 MB.
    MERGE_GROUP_RECORDS = 1 << 24

    def iter_merged(self, ci: int, cs: int):
        """Yield (keys_u64, counts_u32) per spill bucket, ci/cs applied.

        File handles are NOT held open across the merge: a real-WGS run
        makes thousands of segments (3-Gbase demo: ~210; a 30x human
        genome: >6,000) and 2 handles each would blow the default 1024-FD
        ulimit.  Instead, consecutive buckets are batched into GROUPS
        bounded by MERGE_GROUP_RECORDS, and per group each segment is
        opened once, its group byte-range read sequentially, and closed —
        peak FDs O(1), peak RAM O(group), and the reads are larger and
        sequential (friendlier than per-bucket seeks)."""
        from .counter import _merge_runs

        # offsets first (n_seg x (n_buckets+1) int64 — tiny), handles closed
        offs = []
        for i in range(self.n_seg):
            offs.append(np.load(self._seg_paths(i)[2]))
        per_bucket = np.zeros(self.n_buckets, dtype=np.int64)
        for o in offs:
            per_bucket += np.diff(o)

        def read_rows(path, lo, hi, flat=False):
            with open(path, "rb") as f:
                version = np.lib.format.read_magic(f)
                reader = (np.lib.format.read_array_header_1_0
                          if version == (1, 0)
                          else np.lib.format.read_array_header_2_0)
                shape, fortran, dtype = reader(f)
                assert not fortran
                w = shape[1] if len(shape) > 1 else 1
                f.seek(lo * dtype.itemsize * w, os.SEEK_CUR)
                raw = f.read((hi - lo) * dtype.itemsize * w)
            a = np.frombuffer(raw, dtype=dtype)
            return a if flat else a.reshape(-1, w)

        b = 0
        while b < self.n_buckets:
            # group [b, b_hi): at least one bucket, capped by record budget
            b_hi = b + 1
            total = int(per_bucket[b])
            while (b_hi < self.n_buckets
                   and total + per_bucket[b_hi] <= self.MERGE_GROUP_RECORDS):
                total += int(per_bucket[b_hi])
                b_hi += 1
            if total == 0:
                b = b_hi
                continue

            # one sequential read per segment for the whole group
            group_parts: list[list] = [[] for _ in range(b_hi - b)]
            for i in range(self.n_seg):
                o = offs[i]
                lo, hi = int(o[b]), int(o[b_hi])
                if lo == hi:
                    continue
                pk, pc, _ = self._seg_paths(i)
                keys = read_rows(pk, lo, hi)
                cnts = read_rows(pc, lo, hi, flat=True)
                for j in range(b_hi - b):
                    s, e = int(o[b + j]) - lo, int(o[b + j + 1]) - lo
                    if s < e:
                        group_parts[j].append(
                            (keys[s:e], cnts[s:e].astype(np.int64))
                        )

            for j in range(b_hi - b):
                runs = group_parts[j]
                if not runs:
                    continue
                # each slice is a sorted distinct run (chunks were sorted
                # and the bucket partition is stable) -> tree-fold of
                # linear merges instead of a full re-sort
                while len(runs) > 1:
                    nxt = []
                    for i in range(0, len(runs) - 1, 2):
                        nxt.append(_merge_runs(runs[i][0], runs[i][1],
                                               runs[i + 1][0], runs[i + 1][1]))
                    if len(runs) & 1:
                        nxt.append(runs[-1])
                    runs = nxt
                keys, summed = runs[0]
                keep = summed >= ci
                yield keys[keep], np.minimum(summed[keep], cs).astype(np.uint32)
            b = b_hi

    def cleanup(self) -> None:
        self.drop_segments_from(0)
        for f in ("manifest.json",):
            p = os.path.join(self.dir, f)
            if os.path.exists(p):
                os.remove(p)


def count_reads_kmers_spill(reads_path: str, ref_k: int, spill_dir: str, ci: int = 2,
                            cs: int = 255, chunk_kmers: int = 1 << 23, n_buckets: int = 1024,
                            log=None, device=None, resume: bool = True,
                            keep_spill: bool = False, produce_only: bool = False, stats=None):
    """Bounded-memory version of counter.count_reads_kmers: an iterator of
    (keys_u64, counts_u32) batches, one per spill bucket, whose union is
    the in-RAM counter's result (order differs — bucket-major — which no
    consumer observes: counter updates commute).  The sort-count runs on
    ``device`` when one is given, else on the host.  The manifest is
    committed at every read batch boundary, so an interrupted count
    resumes there.  ``produce_only`` counts and spills, marks the manifest
    done and returns None without merging: the producer half of the
    overlapped ``run`` (the consumer later resumes with the same spill_dir
    and skips straight to the merge).  Progress goes to ``log`` (stderr as
    it is at the call).  ``stats`` (``count/stats.py CountStats``), if given,
    takes the time spent reading the reads (``read``), producing runs from
    them (``produce``, the read and the pieces included), writing segments
    (``spill_write``) and merging (``merge``), the device pieces' parts,
    and the count's windows, segments and spill bytes."""
    log = sys.stderr if log is None else log
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
        if stats is not None:
            batches = stats.timed_iter("read", batches)
        runs = (_host_chunk_runs(batches, ref_k, chunk_kmers, flush_each_batch=True)
                if device is None else
                iter_device_runs(batches, ref_k, chunk_kmers, device, flush_each_batch=True,
                                 stats=stats))
        if stats is not None:
            runs = stats.timed_iter("produce", runs)
        batch_i = start_batch
        for run in runs:
            if run is None:  # batch boundary: everything flushed is committed
                batch_i += 1
                commit_manifest(batch_i)
            elif run[0].shape[0]:
                total_windows += int(run[1].sum())
                with stats.timed("spill_write") if stats is not None else nullcontext():
                    store.add_segment(*run)
        commit_manifest(batch_i, done=True)
    if stats is not None:
        stats.windows, stats.segments = total_windows, store.n_seg
        stats.spill_bytes = sum(os.path.getsize(p) for i in range(store.n_seg)
                                for p in store._seg_paths(i))
    where = "" if device is None else f" (sort-count on {device})"
    print(f"{TAG} {total_windows} k-mer occurrences in {store.n_seg} segments; merging "
          f"{n_buckets} buckets{where}", file=log)
    if produce_only:
        return None

    def merged():
        n_out = 0
        buckets = store.iter_merged(ci, cs)
        for keys, cnts in buckets if stats is None else stats.timed_iter("merge", buckets):
            n_out += keys.shape[0]
            yield keys, cnts
        print(f"{TAG} {n_out} distinct k-mers past ci={ci}", file=log)
        if not keep_spill:
            store.cleanup()

    return merged()


# what the producer child must not import: jax and the JAX package (the
# port runs without both) and torch (the child counts on the host only;
# torch would load the CUDA libraries and could touch the card the parent
# holds, and its import alone costs seconds of the child's start-up)
PRODUCER_REFUSES = ("jax", "malva_tpu", "torch")


class _PortOnly:
    """An import finder that refuses :data:`PRODUCER_REFUSES`."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in PRODUCER_REFUSES:
            raise ImportError(f"the spill producer must not import {name}")
        return None


def _produce_main(argv: list[str]) -> int:
    """Producer child of the overlapped ``run``:
    ``python -m malva_tpu_torch.count.spill <reads> <ref_k> <spill_dir>``.
    Counts and spills on the host only (no merge), numpy and the native
    library only: it fails if a refused module is loaded already or is
    imported later.  Its last stderr line gives its peak memory
    (``utils/timing.py peak_rss_gb``), its start-up (the interpreter and
    its imports, until counting begins) and its count's seconds."""
    import argparse
    import time

    from ..utils.timing import peak_rss_from, peak_rss_gb, process_age_s

    ap = argparse.ArgumentParser(prog="malva_tpu_torch.count.spill")
    ap.add_argument("reads")
    ap.add_argument("ref_k", type=int)
    ap.add_argument("spill_dir")
    a = ap.parse_args(argv)

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in PRODUCER_REFUSES)
    if loaded:
        raise ImportError(f"the spill producer must not import {', '.join(loaded)}")
    sys.meta_path.insert(0, _PortOnly())
    from ..utils.native import tune_malloc

    tune_malloc()
    startup = process_age_s()
    t0 = time.perf_counter()
    count_reads_kmers_spill(a.reads, a.ref_k, a.spill_dir, produce_only=True)
    print(f"{TAG} producer: peak RSS {peak_rss_gb():.6g} GB ({peak_rss_from()}), start-up "
          f"{'?' if startup is None else f'{startup:.6g}'} s (interpreter and imports), "
          f"count {time.perf_counter() - t0:.6g} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(_produce_main(sys.argv[1:]))
