"""Index, call and batch phases with the device work on a torch device.

Counterpart of ``malva_tpu/pipeline.py``.  The host layers are
``malva_tpu``'s, imported and not copied: reference and VCF reading,
signature extraction, the host Bloom/exact-map build, the host counter,
the host apply, coverage, genotyping and VCF output.  What differs is
the device branches: the context scan (K2) in :func:`build_index`, the
sample sort-count (K3, ``count/``) and the call step (K1) in
:func:`call` and :func:`call_batch`.  Where the work routes to a mesh
(``backend.mesh_for``: several cards, or an explicit ``mesh=``), the
context scan and the call step run sharded over it
(``parallel/sharded_index.py``: K2 hash-only, K1 hash-only and K4), as
``malva_tpu`` routes through ``_call_mesh``; the sample counting then
runs on the mesh's first device.

``malva_tpu``'s own ``build_index``, ``call``, ``call_batch`` and
``_sample_kmers`` load jax for any backend but ``host``, so they are
never called here; the functions below call its jax-free helpers
instead.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from malva_tpu.count.counter import load_kmc_dump
from malva_tpu.index.bloom_filter import BF
from malva_tpu.index.kmap import KMAP
from malva_tpu.io.fasta import load_reference
from malva_tpu.pipeline import (
    DEVICE_MIN_KMERS,
    DEVICE_MIN_READ_BYTES,
    DEVICE_MIN_REF_POSITIONS,
    Index,
    _flat_query_info,
    _genotype_and_emit,
    _iter_extract_batches,
    _iter_pass2_batches,
    _kmc_batches,
    _kmc_est_kmers,
    _prefetch,
    _reset_counters,
    _scan_and_assign,
    _weights_from_planes,
    apply_sample_counts,
    cleaned_header,
    format_variants,
    genotype_block,
    open_variant_reader,
)
from malva_tpu.utils.config import Config
from malva_tpu.utils.timing import PhaseTimer

from .backend import device_for, mesh_for
from .count.counter import count_reads_kmers
from .index.device import (
    DeviceIndex,
    apply_sample_counts_device,
    apply_sample_counts_stream,
    build_context_device,
    log_step_rate,
)
from .parallel.sharded_index import (
    apply_sample_counts_sharded_stream,
    build_context_sharded,
    log_sharded_step,
    shard_index_routed,
)

TAG = "malva-tpu-torch"


def _route(cfg: Config, work: int | None, floor: int, device=None, mesh=None):
    """``(mesh, None)`` for the sharded device path, ``(None, device)``
    for one torch device, ``(None, None)`` for the host.  An explicit
    ``mesh`` or ``device`` is taken as given; with neither, the backend
    and the work size decide (backend.py)."""
    m = None if mesh is None and device is not None else mesh_for(cfg, work, floor, mesh)
    return (m, None) if m is not None else (None, device_for(cfg, work, floor, device))


def _count_device(device=None, mesh=None):
    """The explicit device of the sample counting: the mesh's first one."""
    return mesh[0] if mesh is not None else device


def _log_stats(stats: dict | None) -> None:
    if stats is not None:
        (log_sharded_step if "shards" in stats else log_step_rate)(stats)


def build_index(cfg: Config, timer: PhaseTimer | None = None, device=None,
                mesh=None) -> Index:
    """malva_tpu.pipeline.build_index with the context scan on a torch
    device or sharded over a mesh when the backend resolves to one (or
    ``device`` or ``mesh`` is given)."""
    timer = timer or PhaseTimer(TAG)
    refs = load_reference(cfg.fasta_path, cfg.strip_chr)
    timer.pelapsed("Reference processed")

    bf = BF(cfg.bf_size)
    ref_bf = KMAP()
    context_bf = BF(cfg.bf_size)
    used_names: list[str] = []
    n_vars = 0
    for flat in _iter_extract_batches(cfg, refs, keep_absent=False,
                                      used_out=used_names, timer=timer):
        n_vars += len(flat.all_vars)
        for is_ref, _L, _idxs, mat in flat.length_groups():
            (ref_bf if is_ref else bf).add_keys(mat)
    timer.pelapsed(f"Processed variants ({n_vars} in blocks)")

    bf.switch_mode()
    fill = len(bf.counts) / max(bf.size, 1)
    print(f"[{TAG}/metrics] alt-BF set bits {len(bf.counts)} (fill {fill:.2e}, "
          f"est FP rate {fill:.2e}); exact map keys {len(ref_bf)}", file=sys.stderr)
    timer.pelapsed("BF creation complete")

    index = Index(bf=bf, ref_bf=ref_bf, context_bf=context_bf)
    total_ref = sum(len(refs[n]) for n in set(used_names) if n in refs)
    m, dev = _route(cfg, total_ref, DEVICE_MIN_REF_POSITIONS, device, mesh)
    refs_used = [refs[n] for n in used_names if n in refs and len(refs[n]) > 0]
    if m is not None:
        build_context_sharded(index, refs_used, cfg, m)
        timer.pelapsed(f"Reference BF creation complete (sharded over {len(m)} shards)")
    elif dev is not None:
        build_context_device(index, refs_used, cfg, dev)
        timer.pelapsed(f"Reference BF creation complete (device {dev})")
    else:
        _host_context_scan(index, refs, used_names, cfg)
        timer.pelapsed("Reference BF creation complete")
    context_bf.switch_mode()
    print(f"[{TAG}/metrics] context-BF set bits {len(context_bf.counts)}", file=sys.stderr)
    return index


def _host_context_scan(index: Index, refs, used_names: list[str], cfg: Config) -> None:
    """The host reference context scan (malva_tpu/pipeline.py:460-483)."""
    off = cfg.center_off
    for seq_name in used_names:
        ref = refs.get(seq_name)
        if ref is None or len(ref) == 0:
            continue
        if len(ref) < cfg.ref_k:
            # upstream clamps the initial substrings for short contigs
            if len(ref) > off and index.bf.test_keys(ref[off : off + cfg.k][None, :])[0]:
                index.context_bf.add_keys(ref[: cfg.ref_k][None, :])
            continue
        n_pos = len(ref) - cfg.ref_k + 1
        chunk = 1 << 20
        for start in range(0, n_pos, chunk):
            stop = min(start + chunk, n_pos)
            windows = np.lib.stride_tricks.sliding_window_view(
                ref[start : stop + cfg.ref_k - 1], cfg.ref_k)
            hits = index.bf.test_keys(windows[:, off : off + cfg.k])
            if hits.any():
                index.context_bf.add_keys(np.ascontiguousarray(windows[hits]))


def call(cfg: Config, index: Index, out=None, timer: PhaseTimer | None = None,
         device=None, mesh=None) -> dict | None:
    """malva_tpu.pipeline.call with the sample counting and the call step
    on a torch device, or the call step sharded over a mesh, where each
    routes there (or ``device`` or ``mesh`` is given).  Covers the spill
    stream, the KMC stream and the in-RAM path.  Returns the call step's
    stats (index/device.py, parallel/sharded_index.py) when a device path
    ran, else None."""
    out = out if out is not None else sys.stdout
    timer = timer or PhaseTimer(TAG)
    refs = load_reference(cfg.fasta_path, cfg.strip_chr)
    timer.pelapsed("Reference processed")
    # pass-2 extraction overlaps the counting phase (pipeline.py:842-852)
    pass2_depth = int(os.environ.get("MALVA_PASS2_PREFETCH", 8 if cfg.spill_dir else 32))
    pass2 = _prefetch(_iter_pass2_batches(cfg, refs), depth=pass2_depth)
    stats = None

    if cfg.spill_dir and not (cfg.from_kmc_dump or cfg.from_kmc_db):
        from .count.spill import count_reads_kmers_spill

        m, dev = _route(cfg, _file_size(cfg.sample_path), DEVICE_MIN_READ_BYTES, device, mesh)
        batches = count_reads_kmers_spill(cfg.sample_path, cfg.ref_k, cfg.spill_dir,
                                          device=m[0] if m is not None else dev)
        if m is not None:
            stats = apply_sample_counts_sharded_stream(index, _prefetch(batches), cfg, m)
        elif dev is not None:
            stats = apply_sample_counts_stream(index, _prefetch(batches), cfg, dev)
        else:
            for keys, cnts in _prefetch(batches):
                apply_sample_counts(index, keys, cnts, cfg)
        timer.pelapsed("Sample k-mer counting + BF weights (spill)")
    elif cfg.from_kmc_dump or cfg.from_kmc_db:
        stats = _apply_kmc_stream(cfg, index, cfg.sample_path,
                                  *_kmc_route(cfg, cfg.sample_path, device, mesh))
        timer.pelapsed("Sample k-mer stream + BF weights")
    else:
        contexts, counts = _sample_kmers(cfg, cfg.sample_path, _count_device(device, mesh))
        timer.pelapsed("Sample k-mer counting")
        m, dev = _route(cfg, contexts.shape[0], DEVICE_MIN_KMERS, device, mesh)
        if m is not None:
            stats = apply_sample_counts_sharded_stream(index, [(contexts, counts)], cfg, m)
        elif dev is not None:
            stats = apply_sample_counts_device(index, contexts, counts, cfg, dev)
        else:
            apply_sample_counts(index, contexts, counts, cfg)
        timer.pelapsed("BF weights created")
    _log_stats(stats)

    _genotype_and_emit(cfg, index, refs, out, timer, batches=pass2)
    return stats


def _file_size(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


def _sample_kmers(cfg: Config, path: str, device=None):
    """-> (contexts, counts), as malva_tpu.pipeline._sample_kmers: 2-bit
    packed uint64 rows from the counter, with the sort-count on a torch
    device when the reads route to one (or ``device`` is given), or ASCII
    rows from an external KMC dump or database."""
    if cfg.from_kmc_dump:
        return load_kmc_dump(path, cfg.ref_k)
    if cfg.from_kmc_db:
        from malva_tpu.io.kmc import load_kmc_db

        return load_kmc_db(path, cfg.ref_k)
    dev = device_for(cfg, _file_size(path), DEVICE_MIN_READ_BYTES, device)
    return count_reads_kmers(path, cfg.ref_k, device=dev, return_packed=True)


def _kmc_route(cfg: Config, path: str, device=None, mesh=None):
    """(mesh, device) of an external KMC artifact's call step, routed by
    its estimated k-mer count (see :func:`_route`)."""
    return _route(cfg, _kmc_est_kmers(cfg, path), DEVICE_MIN_KMERS, device, mesh)


def _apply_kmc_stream(cfg: Config, index: Index, path: str, mesh, target,
                      dev: DeviceIndex | None = None, sharded=None) -> dict | None:
    """Stream an external KMC artifact through the call step sharded over
    ``mesh`` (reusing ``sharded`` when given), on ``target`` (reusing
    ``dev``), or through the host apply when both are None; the step's
    stats, or None on the host."""
    batches = _kmc_batches(cfg, path)
    if mesh is not None:
        return apply_sample_counts_sharded_stream(index, batches, cfg, mesh, sharded=sharded)
    if target is not None:
        return apply_sample_counts_stream(index, batches, cfg, target, dev=dev)
    for contexts, counts in batches:
        apply_sample_counts(index, contexts, counts, cfg)
    return None


def call_batch(cfg: Config, index: Index, sample_paths: list[str], outs: list,
               timer: PhaseTimer | None = None, device=None, mesh=None) -> None:
    """malva_tpu.pipeline.call_batch on one torch device or a mesh: N read
    sets against one index, one VCF to each of ``outs``.

    Phase A counts each sample (on the device where it routes there) and
    runs its call step into a per-sample counter plane; the device index
    (or the sharded index, on a mesh) is uploaded once, at the first
    sample that routes there, and each later sample restarts it from the
    zeroed host counters.  Phase B makes one pass over the VCF and answers
    every sample from its plane (malva_tpu's host helpers, unchanged).
    The index's counter state is unspecified after this returns."""
    timer = timer or PhaseTimer(TAG)
    refs = load_reference(cfg.fasta_path, cfg.strip_chr)
    timer.pelapsed("Reference processed")

    dev = sharded = None
    planes: list[tuple[np.ndarray, np.ndarray]] = []
    for sample_path in sample_paths:
        _reset_counters(index)
        kmc = cfg.from_kmc_dump or cfg.from_kmc_db
        if kmc:
            m, target = _kmc_route(cfg, sample_path, device, mesh)
        else:
            contexts, counts = _sample_kmers(cfg, sample_path, _count_device(device, mesh))
            m, target = _route(cfg, contexts.shape[0], DEVICE_MIN_KMERS, device, mesh)
        if m is not None and sharded is None:
            sharded = shard_index_routed(index, cfg, m)
            print(f"[{TAG}] sharded index uploaded to {len(m)} shards once for "
                  f"{len(sample_paths)} samples", file=sys.stderr)
        if target is not None and dev is None:
            dev = DeviceIndex.from_host(index, cfg, target)
            print(f"[{TAG}] device index uploaded to {target} once for "
                  f"{len(sample_paths)} samples", file=sys.stderr)
        if kmc:
            stats = _apply_kmc_stream(cfg, index, sample_path, m, target, dev=dev,
                                      sharded=sharded)
        elif m is not None:
            stats = apply_sample_counts_sharded_stream(index, [(contexts, counts)], cfg, m,
                                                       sharded=sharded)
        elif target is not None:
            stats = apply_sample_counts_device(index, contexts, counts, cfg, target, dev=dev)
        else:
            stats = None
            apply_sample_counts(index, contexts, counts, cfg)
        _log_stats(stats)
        planes.append((index.bf.counts.astype(np.uint16),  # truncation == mod 2^16
                       index.ref_bf.snapshot_values()))
        timer.pelapsed(f"Counters ready: {sample_path}")

    reader = open_variant_reader(cfg.vcf_path, cfg.samples)
    header = cleaned_header(reader.meta_lines, cfg.verbose)
    for out in outs:
        out.write(header)
    n = 0
    for flat in _prefetch(_iter_pass2_batches(cfg, refs)):
        qinfo = _flat_query_info(index, flat)  # resolve queries once
        for (bf_plane, kmap_plane), out in zip(planes, outs):
            for v in flat.all_vars:
                v.computed_gts = []
            _scan_and_assign(_weights_from_planes(qinfo, bf_plane, kmap_plane), flat)
            genotype_block(flat.all_vars, cfg.max_coverage, cfg.haploid, cfg.error_rate)
            for line in format_variants(flat.all_vars, cfg.haploid, cfg.verbose):
                out.write(line + "\n")
        n += len(flat.all_vars)
    timer.pelapsed(f"VCF parsing and genotyping ({n} variants x {len(planes)} samples)")
