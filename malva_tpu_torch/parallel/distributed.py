"""Multi-process orchestration on ``torch.distributed``.

Counterpart of ``malva_tpu/parallel/distributed.py``, with the same
division of work:

* every process reads its own share of the read files (``host_shard``)
  and counts it with the host counter (spilled to disk with
  ``spill_dir``), without the ci/cs threshold, which is not linear and
  applies after the global merge;
* distinct (key, count) runs are exchanged in lockstep rounds with
  per-process hash-range ownership: each batch is split by owner and only
  the owner merges and keeps its slice, so a process holds
  O(global distinct / processes) plus one exchange buffer;
* ci/cs apply on the owner after the merge; each process applies its owned
  k-mers to zeroed counter planes, and the planes merge with one global
  sum (counter adds commute, mod 2^32 exact);
* the variant pass and pass 2 are split by extraction batch, and rank 0
  writes the VCF.

Every collective moves host arrays, and the counting and the apply run on
the host, as in JAX, so the process group is ``gloo`` over CPU tensors.
``all_to_all`` is ``all_to_all_single`` with uneven splits, and the
uint32 plane sum is an int64 ``all_reduce`` masked to 32 bits.  JAX's
workarounds are gone: torch moves 64-bit integers exactly (no uint32
lanes), and a collective takes any shape (no power-of-two row padding, no
per-shape jit caches).  Rank and world come from the process group; with
no group the world is one process.
"""

from __future__ import annotations

import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..count.counter import _merge_runs
from ..count.spill import _bucket_of
from ..utils.config import Config

TAG = "malva-tpu-torch"

# Ownership hash width: ranges are assigned from the spill bucket hash so
# keys within one range share no lexicographic structure (canonical
# k-mers are non-uniform in their prefix — see count.spill._bucket_of).
_OWNER_RANGES = 1024


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, timeout: float = 600.0) -> None:
    """Join the ``gloo`` process group at ``tcp://coordinator`` (no-op for
    one process), then cross-check the topology: every process gathers
    every (num_processes, process_id) view and all must agree, since each
    process is told both on its own command line (JAX ``:40-73``).
    Collectives time out after ``timeout`` seconds."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))
    mine = torch.tensor([num_processes, process_id], dtype=torch.int64)
    views = [torch.zeros(2, dtype=torch.int64) for _ in range(dist.get_world_size())]
    dist.all_gather(views, mine)
    topo = torch.stack(views).tolist()
    if (len(topo) != num_processes or any(n != num_processes for n, _ in topo)
            or sorted(p for _, p in topo) != list(range(num_processes))):
        raise RuntimeError(f"inconsistent process topology: (num_processes, process_id) "
                           f"views = {topo}")


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard(paths: list[str]) -> list[str]:
    """The read files this process is responsible for (round-robin)."""
    pid, n = world()
    return [p for i, p in enumerate(paths) if i % n == pid]


def _as_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host array as a tensor gloo moves exactly (uint32 as int64)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    elif arr.dtype == np.uint64:
        arr = arr.view(np.int64)
    return torch.from_numpy(arr)


class _Collectives:
    """The exchanges of host arrays (JAX ``:85-170``)."""

    @staticmethod
    def all_to_all(send: np.ndarray, send_counts: list[int],
                   recv_counts: list[int]) -> np.ndarray:
        """Rows ``[sum(send_counts[:d]), ...)`` of ``send`` go to process d;
        returns the rows received, in source order.  int64 rows."""
        out = torch.empty((sum(recv_counts),) + send.shape[1:], dtype=torch.int64)
        dist.all_to_all_single(out, torch.from_numpy(np.ascontiguousarray(send)),
                               output_split_sizes=recv_counts, input_split_sizes=send_counts)
        return out.numpy()

    @staticmethod
    def psum_u32(plane: np.ndarray) -> np.ndarray:
        """Element-wise mod-2^32 sum of one uint32 plane across processes
        (counter adds commute; the sum wraps the same in any order)."""
        t = torch.from_numpy(np.asarray(plane, dtype=np.uint32).astype(np.int64))
        if world()[1] > 1 and t.numel():
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return (t.numpy() & 0xFFFFFFFF).astype(np.uint32)


def _all_gather_counts(mine: np.ndarray) -> np.ndarray:
    """(world, len(mine)) int64: every process's row."""
    t = torch.from_numpy(np.asarray(mine, dtype=np.int64))
    rows = [torch.zeros_like(t) for _ in range(world()[1])]
    dist.all_gather(rows, t)
    return torch.stack(rows).numpy()


def _exchange_rows(coll: _Collectives, keys: np.ndarray, cnts: np.ndarray,
                   owner: np.ndarray, w: int, stats: dict | None = None):
    """One-round ranged exchange (JAX ``:173``): every process sends each
    row to its owner and receives the rows it owns, in one uneven
    ``all_to_all``.  Returns [(keys, cnts)] received, per source, in
    sorted-run order."""
    pid, H = world()
    my_counts = np.bincount(owner, minlength=H).astype(np.int64)
    all_counts = _all_gather_counts(my_counts)  # [src, dst]
    if not all_counts.any():
        return []
    order = np.argsort(owner, kind="stable")
    rows = np.concatenate([np.ascontiguousarray(keys[order]).view(np.int64).reshape(-1, w),
                           cnts[order].astype(np.int64)[:, None]], axis=1)
    recv = coll.all_to_all(rows, my_counts.tolist(), all_counts[:, pid].tolist())
    if stats is not None:
        stats["rounds"] = stats.get("rounds", 0) + 1
        stats["rows_sent"] = stats.get("rows_sent", 0) + int(keys.shape[0])
    out, at = [], 0
    for n in all_counts[:, pid].tolist():
        if n:
            part = recv[at : at + n]
            out.append((np.ascontiguousarray(part[:, :w]).view(np.uint64),
                        np.ascontiguousarray(part[:, w])))
            if stats is not None:
                stats["rows_kept"] = stats.get("rows_kept", 0) + n
        at += n
    return out


def _allgather_padded(arr: np.ndarray) -> list[np.ndarray]:
    """Every process's variable-length array (rows padded to the longest
    for the one ``all_gather``, then cut back)."""
    pid, H = world()
    if H == 1:
        return [arr]
    lens = _all_gather_counts(np.array([arr.shape[0]]))[:, 0]
    m = int(lens.max())
    if m == 0:
        return [arr[:0] for _ in range(H)]
    buf = np.zeros((m,) + arr.shape[1:], dtype=arr.dtype)
    buf[: arr.shape[0]] = arr
    t = _as_tensor(buf)
    parts = [torch.zeros_like(t) for _ in range(H)]
    dist.all_gather(parts, t)
    return [p.numpy()[:n].astype(arr.dtype) for p, n in zip(parts, lens.tolist())]


def _or_merge_words(words: np.ndarray) -> None:
    """In-place bitwise OR of one Bloom word plane across processes, as
    sparse (index, word) pairs (bit adds are idempotent, so the OR of the
    planes equals the sequential adds)."""
    pid, H = world()
    if H <= 1:
        return
    nz = np.flatnonzero(words)
    pairs = np.stack([nz.astype(np.int64), words[nz].astype(np.int64)], axis=1)
    for h, p in enumerate(_allgather_padded(pairs)):
        if h != pid and p.shape[0]:
            words[p[:, 0]] |= p[:, 1].astype(words.dtype)


def _tree_merge(runs: list) -> tuple[np.ndarray, np.ndarray]:
    """Pairwise tree merge of sorted distinct (keys, counts) runs."""
    if not runs:
        raise ValueError("no runs")
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            ka, ca = runs[i]
            kb, cb = runs[i + 1]
            nxt.append(_merge_runs(ka, ca, kb, cb))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


def _batch_ref_keys(flat) -> tuple[np.ndarray, bytes]:
    """One batch's reference-allele KMAP keys, first-occurrence-deduped in
    the exact single-process insertion order (length_groups order: length
    ascending, row order within).  Returns (lengths int32, concat bytes)."""
    from ..ops.seq import canonical, truncate_at_nul

    groups = []
    any_nul = False
    for is_ref, _L, _idxs, mat in flat.length_groups():
        if not is_ref:
            continue
        ck = truncate_at_nul(canonical(mat))
        groups.append(ck)
        if ck.size and ck.min() == 0:
            any_nul = True
    if not groups:
        return np.zeros(0, np.int32), b""
    if len(groups) == 1 and not any_nul:
        g = np.ascontiguousarray(groups[0])
        v = g.view(f"V{g.shape[1]}").ravel()
        _, first = np.unique(v, return_index=True)
        data = g[np.sort(first)]
        return (np.full(data.shape[0], g.shape[1], np.int32),
                data.tobytes())
    # general path (NUL-truncated or multiple length classes): ordered set
    seen = set()
    keys = []
    for ck in groups:
        for row in ck:
            kb = row.tobytes().rstrip(b"\x00")
            if kb not in seen:
                seen.add(kb)
                keys.append(kb)
    return (np.asarray([len(k) for k in keys], np.int32), b"".join(keys))


def _merged_kmap(my_keys: list):
    """Union of the per-process per-batch key streams into one KMAP in the
    exact order one process would insert them: batches ascending, first
    occurrence wins (JAX ``:464``)."""
    from ..index.kmap import KMAP

    metas, datas = [], []
    for bi, lens, data in my_keys:
        meta = np.empty((lens.shape[0], 2), np.int64)
        meta[:, 0] = bi
        meta[:, 1] = lens
        metas.append(meta)
        datas.append(np.frombuffer(data, dtype=np.uint8))
    meta = np.concatenate(metas) if metas else np.zeros((0, 2), np.int64)
    data = np.concatenate(datas) if datas else np.zeros(0, np.uint8)

    # each batch is owned by one process and every stream is batch-ascending,
    # so the per-batch slices in batch order are the one-process stream
    slices = []  # (batch_id, stream, row_lo, row_hi)
    streams = []
    for m2, d in zip(_allgather_padded(meta), _allgather_padded(data)):
        if m2.shape[0] == 0:
            continue
        offs = np.zeros(m2.shape[0] + 1, np.int64)
        np.cumsum(m2[:, 1], out=offs[1:])
        si = len(streams)
        streams.append((m2, offs, d.tobytes()))
        bids = m2[:, 0]
        starts = np.flatnonzero(np.diff(bids, prepend=bids[0] - 1))
        ends = np.append(starts[1:], bids.shape[0])
        slices += [(int(bids[lo]), si, lo, hi) for lo, hi in zip(starts.tolist(), ends.tolist())]
    slices.sort()
    km = KMAP()
    kmers = km.kmers
    for _b, si, lo, hi in slices:
        m2, offs, blob = streams[si]
        at = int(offs[lo])
        for ln in m2[lo:hi, 1].tolist():
            key = blob[at : at + ln]
            at += ln
            if key not in kmers:
                kmers[key] = 0
    return km


def build_index_distributed(cfg: Config, timer=None):
    """The index phase split across processes (JAX ``:375``): every
    process runs the cheap record scan, but the GT parse and signature
    extraction only for its round-robin batches; the Bloom planes merge by
    OR and the exact-map keys by the ordered union.  The reference context
    scan is split by 1M-position chunk, its bits merged by OR."""
    from ..index.bloom_filter import BF
    from ..io.fasta import load_reference
    from ..pipeline import Index, _iter_extract_batches
    from ..utils.timing import PhaseTimer

    pid, H = world()
    timer = timer or PhaseTimer(TAG)
    refs = load_reference(cfg.fasta_path, cfg.strip_chr)
    bf = BF(cfg.bf_size)
    context_bf = BF(cfg.bf_size)
    used_names: list[str] = []
    n_vars = 0
    my_keys: list = []
    for bi, flat in _iter_extract_batches(cfg, refs, keep_absent=False, used_out=used_names,
                                          owned=lambda b: b % H == pid):
        n_vars += flat.n_vars
        lens, data = _batch_ref_keys(flat)
        if lens.shape[0]:
            my_keys.append((bi, lens, data))
        for is_ref, _L, _idxs, mat in flat.length_groups():
            if not is_ref:
                bf.add_keys(mat)
    timer.pelapsed(f"Processed variants (process {pid}: {n_vars} in owned batches)")

    _or_merge_words(bf.words)
    ref_bf = _merged_kmap(my_keys)
    bf.switch_mode()
    if pid == 0:
        print(f"[{TAG}/metrics] alt-BF set bits {len(bf.counts)} "
              f"(fill {len(bf.counts) / max(bf.size, 1):.2e}); exact map keys {len(ref_bf)}",
              file=sys.stderr)
    timer.pelapsed("BF creation complete (merged)")

    off = cfg.center_off
    chunk = 1 << 20
    ci = 0
    for seq_name in used_names:
        ref = refs.get(seq_name)
        if ref is None or len(ref) == 0:
            continue
        if len(ref) < cfg.ref_k:
            if ci % H == pid and len(ref) > off and bf.test_keys(ref[off : off + cfg.k][None, :])[0]:
                context_bf.add_keys(ref[: cfg.ref_k][None, :])
            ci += 1
            continue
        n_pos = len(ref) - cfg.ref_k + 1
        for start in range(0, n_pos, chunk):
            if ci % H == pid:
                windows = np.lib.stride_tricks.sliding_window_view(
                    ref[start : min(start + chunk, n_pos) + cfg.ref_k - 1], cfg.ref_k)
                hits = bf.test_keys(windows[:, off : off + cfg.k])
                if hits.any():
                    context_bf.add_keys(np.ascontiguousarray(windows[hits]))
            ci += 1
    _or_merge_words(context_bf.words)
    context_bf.switch_mode()
    timer.pelapsed("Reference BF creation complete (split scan, merged)")
    return Index(bf=bf, ref_bf=ref_bf, context_bf=context_bf)


def count_distributed(reads_paths: list[str], cfg: Config, ci: int = 2, cs: int = 255,
                      spill_dir: str | None = None) -> tuple[np.ndarray, np.ndarray]:
    """This process's owned slice of the global distinct k-mers, as
    (keys_packed_u64, counts_u32) with ci/cs applied; the union over
    processes is exactly the one-process counter's output (JAX ``:519``).
    Counting spills to disk with ``spill_dir``."""
    pid, H = world()

    def local_batches():
        # raw local counts: ci=1 and no cap, since the thresholds are global
        if spill_dir is not None:
            from ..count.spill import count_reads_kmers_spill

            for path_i, path in enumerate(host_shard(reads_paths)):
                yield from count_reads_kmers_spill(path, cfg.ref_k,
                                                   f"{spill_dir}/h{pid}_{path_i}",
                                                   ci=1, cs=1 << 62)
        else:
            from ..count.counter import count_reads_kmers

            for path in host_shard(reads_paths):
                yield count_reads_kmers(path, cfg.ref_k, ci=1, cs=1 << 62, return_packed=True)

    w = (cfg.ref_k + 31) // 32
    my_runs: list = []
    it = iter(local_batches())
    coll = _Collectives()
    stats: dict = {}
    while True:
        batch = next(it, None)
        have = np.array([0 if batch is None else 1])
        if H > 1:
            have = _all_gather_counts(have)
        if not have.any():
            break
        if batch is None:
            keys, cnts = np.zeros((0, w), np.uint64), np.zeros(0, np.int64)
        else:
            keys = np.ascontiguousarray(batch[0], dtype=np.uint64)
            cnts = np.asarray(batch[1], dtype=np.int64)
        if H == 1:
            if keys.shape[0]:
                my_runs.append((keys, cnts))
            continue
        owner = (_bucket_of(keys, _OWNER_RANGES) % H if keys.shape[0]
                 else np.zeros(0, np.int64))
        for kk, cc in _exchange_rows(coll, keys, cnts, owner, w, stats):
            my_runs.append((kk, cc))
    if stats:
        print(f"[{TAG}/dist] process {pid}/{H}: exchange {stats.get('rounds', 0)} rounds x 1 "
              f"all_to_all, {stats.get('rows_sent', 0)} rows sent, "
              f"{stats.get('rows_kept', 0)} kept", file=sys.stderr)

    if my_runs:
        keys, counts = _tree_merge(my_runs)
    else:
        keys, counts = np.zeros((0, w), np.uint64), np.zeros(0, np.int64)
    keep = counts >= ci
    keys = keys[keep]
    counts = np.minimum(counts[keep], cs).astype(np.uint32)
    print(f"[{TAG}/dist] process {pid}/{H}: owns {keys.shape[0]} distinct k-mers past ci={ci}",
          file=sys.stderr)
    return keys, counts


def call_distributed(cfg: Config, index, reads_paths: list[str], out,
                     spill_dir: str | None = None) -> None:
    """The call phase over the process group (JAX ``:608``): split count
    and ranged exchange, each process's owned k-mers applied to zeroed
    counter planes, one global plane sum, pass 2 split by batch, the VCF
    written by rank 0 (``out`` is only written there)."""
    from ..io.fasta import load_reference
    from ..pipeline import _reset_counters, apply_sample_counts
    from ..utils.timing import PhaseTimer

    keys, counts = count_distributed(reads_paths, cfg, spill_dir=spill_dir)
    _reset_counters(index)
    if keys.shape[0]:
        apply_sample_counts(index, keys, counts, cfg)
    # counter adds commute, so the sum of the planes is the sequential
    # apply (mod 2^32; the 16-bit read wraps after the sum, as it would)
    coll = _Collectives()
    index.bf.counts = coll.psum_u32(index.bf.counts)
    vals = coll.psum_u32(index.ref_bf.snapshot_values())
    for k, v in zip(list(index.ref_bf.kmers.keys()), vals.tolist()):
        index.ref_bf.kmers[k] = v

    refs = load_reference(cfg.fasta_path, cfg.strip_chr)
    _genotype_and_emit_distributed(cfg, index, refs, out, PhaseTimer(TAG))


def _gather_blobs(blobs: list) -> list | None:
    """Per-batch (batch_id, bytes) pairs of every process, on rank 0, in
    batch order (None on the other ranks)."""
    data = np.frombuffer(b"".join(b for _, b in blobs), dtype=np.uint8)
    meta = np.asarray([[bi, len(b)] for bi, b in blobs], dtype=np.int64).reshape(-1, 2)
    metas = _allgather_padded(meta)
    datas = _allgather_padded(data)
    if world()[0] != 0:
        return None
    out = []
    for m2, d in zip(metas, datas):
        blob = d.tobytes()
        at = 0
        for bi, ln in m2.tolist():
            out.append((bi, blob[at : at + ln]))
            at += ln
    out.sort(key=lambda t: t[0])
    return out


def _genotype_and_emit_distributed(cfg: Config, index, refs, out, timer) -> None:
    """Pass 2 split by extraction batch (JAX ``:682``): coverage,
    genotyping and line formatting on the batch's owner; rank 0 writes
    the header and the batches in order."""
    from ..io.vcf import cleaned_header, open_variant_reader
    from ..models.genotype_host import format_variants, genotype_block
    from ..pipeline import _iter_extract_batches, _set_coverages_flat

    pid, H = world()
    blobs: list[tuple[int, bytes]] = []
    n = 0
    for bi, flat in _iter_extract_batches(cfg, refs, keep_absent=True,
                                          owned=lambda b: b % H == pid):
        _set_coverages_flat(index, flat)
        genotype_block(flat.all_vars, cfg.max_coverage, cfg.haploid, cfg.error_rate)
        text = "".join(line + "\n"
                       for line in format_variants(flat.all_vars, cfg.haploid, cfg.verbose))
        blobs.append((bi, text.encode()))
        n += len(flat.all_vars)
    gathered = _gather_blobs(blobs)
    if pid == 0:
        reader = open_variant_reader(cfg.vcf_path, cfg.samples)
        out.write(cleaned_header(reader.meta_lines, cfg.verbose))
        for _bi, b in gathered:
            out.write(b.decode())
    timer.pelapsed(f"VCF parsing and genotyping ({n} variants on process {pid})")
