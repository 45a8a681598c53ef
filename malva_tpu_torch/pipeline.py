"""Index and call phases with the device work on a torch device.

Counterpart of ``malva_tpu/pipeline.py``.  The host layers are
``malva_tpu``'s, imported and not copied: reference and VCF reading,
signature extraction, the host Bloom/exact-map build, sample counting,
the host apply, coverage, genotyping and VCF output.  What differs is
the device branches: the context scan (K2) in :func:`build_index` and
the call step (K1) in :func:`call`.

``malva_tpu``'s own ``build_index``, ``call`` and ``_sample_kmers`` load
jax for any backend but ``host``, so they are never called here; the
functions below call its jax-free helpers instead.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from malva_tpu.count.counter import count_reads_kmers
from malva_tpu.index.bloom_filter import BF
from malva_tpu.index.kmap import KMAP
from malva_tpu.io.fasta import load_reference
from malva_tpu.pipeline import (
    DEVICE_MIN_KMERS,
    DEVICE_MIN_READ_BYTES,
    DEVICE_MIN_REF_POSITIONS,
    Index,
    _genotype_and_emit,
    _iter_extract_batches,
    _iter_pass2_batches,
    _kmc_batches,
    _kmc_est_kmers,
    _prefetch,
    apply_sample_counts,
)
from malva_tpu.utils.config import Config
from malva_tpu.utils.timing import PhaseTimer

from .backend import device_for
from .index.device import (
    apply_sample_counts_device,
    apply_sample_counts_stream,
    build_context_device,
    log_step_rate,
)

TAG = "malva-tpu-torch"


def build_index(cfg: Config, timer: PhaseTimer | None = None, device=None) -> Index:
    """malva_tpu.pipeline.build_index with the context scan on a torch
    device when the backend resolves to one (or ``device`` is given)."""
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
    dev = device_for(cfg, total_ref, DEVICE_MIN_REF_POSITIONS, device)
    if dev is not None:
        refs_used = [refs[n] for n in used_names if n in refs and len(refs[n]) > 0]
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


def _note_host_counting() -> None:
    print(f"[{TAG}] sample k-mers are counted by the native host counter "
          f"(the device sort-count is not ported yet); the counts are identical",
          file=sys.stderr)


def call(cfg: Config, index: Index, out=None, timer: PhaseTimer | None = None,
         device=None) -> dict | None:
    """malva_tpu.pipeline.call with the call step on a torch device when
    the backend resolves to one (or ``device`` is given).  Covers the
    spill stream, the KMC stream and the in-RAM path.  Returns the call
    step's stats (index/device.py) when the device path ran, else None."""
    out = out if out is not None else sys.stdout
    timer = timer or PhaseTimer(TAG)
    refs = load_reference(cfg.fasta_path, cfg.strip_chr)
    timer.pelapsed("Reference processed")
    # pass-2 extraction overlaps the counting phase (pipeline.py:842-852)
    pass2_depth = int(os.environ.get("MALVA_PASS2_PREFETCH", 8 if cfg.spill_dir else 32))
    pass2 = _prefetch(_iter_pass2_batches(cfg, refs), depth=pass2_depth)
    stats = None

    if cfg.spill_dir and not (cfg.from_kmc_dump or cfg.from_kmc_db):
        from malva_tpu.count.spill import count_reads_kmers_spill

        try:
            nbytes = os.path.getsize(cfg.sample_path)
        except OSError:
            nbytes = 0
        dev = device_for(cfg, nbytes, DEVICE_MIN_READ_BYTES, device)
        batches = count_reads_kmers_spill(cfg.sample_path, cfg.ref_k, cfg.spill_dir,
                                          use_device=False)
        if dev is not None:
            _note_host_counting()
            stats = apply_sample_counts_stream(index, _prefetch(batches), cfg, dev)
        else:
            for keys, cnts in _prefetch(batches):
                apply_sample_counts(index, keys, cnts, cfg)
        timer.pelapsed("Sample k-mer counting + BF weights (spill)")
    elif cfg.from_kmc_dump or cfg.from_kmc_db:
        dev = device_for(cfg, _kmc_est_kmers(cfg, cfg.sample_path), DEVICE_MIN_KMERS, device)
        batches = _kmc_batches(cfg, cfg.sample_path)
        if dev is not None:
            stats = apply_sample_counts_stream(index, batches, cfg, dev)
        else:
            for contexts, counts in batches:
                apply_sample_counts(index, contexts, counts, cfg)
        timer.pelapsed("Sample k-mer stream + BF weights")
    else:
        contexts, counts = count_reads_kmers(cfg.sample_path, cfg.ref_k, use_device=False,
                                             return_packed=True)
        timer.pelapsed("Sample k-mer counting")
        dev = device_for(cfg, contexts.shape[0], DEVICE_MIN_KMERS, device)
        if dev is not None:
            _note_host_counting()
            stats = apply_sample_counts_device(index, contexts, counts, cfg, dev)
        else:
            apply_sample_counts(index, contexts, counts, cfg)
        timer.pelapsed("BF weights created")
    if stats is not None:
        log_step_rate(stats)

    _genotype_and_emit(cfg, index, refs, out, timer, batches=pass2)
    return stats

