"""Index, call and batch phases, with the device work on a torch device.

Counterpart of ``malva_tpu/pipeline.py``, whose host layers the port keeps
as its own copies (this module's host half, and the modules it imports):
reference and VCF reading, signature extraction, the host Bloom/exact-map
build, the index's npz persistence (the same layout, so an index saved by
either package loads in the other), the host counter, the host apply,
coverage, genotyping and VCF output.  What differs is the device
branches: the context scan (K2) in :func:`build_index`, the sample
sort-count (K3, ``count/``) and the call step (K1) in :func:`call` and
:func:`call_batch`.  Where the work routes to a mesh
(``backend.mesh_for``: several cards, or an explicit ``mesh=``), the
context scan and the call step run sharded over it
(``parallel/sharded_index.py``: K2 hash-only, K1 hash-only and K4), as
``malva_tpu`` routes through ``_call_mesh``; the sample counting then
runs on the mesh's first device.  The device layers (``index/device.py``,
``parallel/``) and torch are imported in the branches that take a device
or a mesh, where ``malva_tpu`` imports its own and jax, so the ``host``
backend runs without torch.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
from dataclasses import dataclass

import numpy as np

from .backend import device_for, mesh_for, start_cards
from .count.counter import count_reads_kmers, load_kmc_dump
from .index.bloom_filter import BF
from .index.kmap import KMAP
from .io.fasta import load_reference
from .io.vcf import VcfReader, cleaned_header, open_variant_reader, parse_record
from .models.genotype_host import format_variants, genotype_block
from .utils import native
from .utils.config import Config
from .utils.errors import InputError
from .utils.timing import PhaseTimer, carried, count, span
from .variants.blocks import VB, are_near
from .variants.variant import EMPTY_BOOL, EMPTY_I32, Variant, to_columns

TAG = "malva-tpu-torch"


@dataclass
class Index:
    bf: BF
    ref_bf: KMAP
    context_bf: BF


# Work-size floors for auto device routing: below these, host numpy beats
# the device path's fixed costs (index upload, kernel builds, padded
# batches) by a wide margin.
DEVICE_MIN_REF_POSITIONS = 1 << 25
DEVICE_MIN_KMERS = 1 << 22
DEVICE_MIN_READ_BYTES = 1 << 26


# Extraction batch size (variants a batch): blocks accumulate until this
# many variants, then one GT step and one native call extract the whole
# batch (OpenMP across blocks and a long block's 64-variant chunks) and
# the flat result feeds both passes.  Bounds pass 2's GT-row retention to
# O(batch x samples).
EXTRACT_VARS = 4096


class FlatExtract:
    """Flat signature-extraction result for a batch of variant blocks.

    Replaces the per-block VK_GROUP dicts: one entry per (variant, allele)
    target holding ``tgt_nsig`` signatures; ``sig_nk`` k-mers per
    signature; k-mer byte strings concatenated in ``bytes`` with per-k-mer
    ``kmer_len``.  ``tgt_var`` indexes ``all_vars`` (the batch's
    variants, in its columns' order).  Within-signature k-mer order is
    preserved (the reference's incremental integer mean is
    order-dependent, main.cpp:162-181); signature order within an allele
    is free (coverage is a max over signatures)."""

    __slots__ = ("cols", "n_vars", "tgt_var", "tgt_allele", "tgt_nsig", "sig_nk",
                 "kmer_len", "bytes", "_starts", "_per_kmer_ref", "_slot_of",
                 "_n_slots")

    def __init__(self, cols, tgt_var, tgt_allele, tgt_nsig, sig_nk, kmer_len, bytes_u8):
        self.cols = cols
        self.n_vars = cols.n_vars
        self.tgt_var = tgt_var
        self.tgt_allele = tgt_allele
        self.tgt_nsig = tgt_nsig
        self.sig_nk = sig_nk
        self.kmer_len = kmer_len
        self.bytes = bytes_u8
        self._starts = None

    @property
    def all_vars(self) -> list:
        """The batch's Variants (``native.Columns.variants``)."""
        return self.cols.variants()

    def _derive(self):
        if self._starts is not None:
            return
        kl = self.kmer_len
        self._starts = np.zeros(kl.shape[0] + 1, dtype=np.int64)
        np.cumsum(kl, out=self._starts[1:])
        per_sig_ref = np.repeat(self.tgt_allele == 0, self.tgt_nsig)
        self._per_kmer_ref = np.repeat(per_sig_ref, self.sig_nk)
        nonempty = kl > 0
        self._slot_of = np.cumsum(nonempty, dtype=np.int64) - 1
        self._n_slots = int(self._slot_of[-1]) + 1 if kl.shape[0] else 0

    def length_groups(self):
        """Yield (is_ref, L, kmer_indices, (n, L) matrix) per (is_ref,
        length) class of nonempty k-mers."""
        self._derive()
        kl = self.kmer_len
        for L in np.unique(kl[kl > 0]).tolist():
            len_sel = kl == L
            for is_ref in (True, False):
                idxs = np.flatnonzero(len_sel & (self._per_kmer_ref == is_ref))
                if idxs.shape[0] == 0:
                    continue
                mat = self.bytes[self._starts[idxs][:, None] + np.arange(L)]
                yield is_ref, L, idxs, mat

    def slots(self, idxs):
        """Global occurrence slots (over nonempty k-mers) of kmer_indices."""
        return self._slot_of[idxs]

    @property
    def n_slots(self):
        self._derive()
        return self._n_slots

    def sig_lens(self):
        """Nonempty-k-mer count per signature (the coverage scan's run
        lengths; empty strings count 0 and are skipped, main.cpp:162)."""
        self._derive()
        if self.sig_nk.shape[0] == 0:
            return np.zeros(0, dtype=np.int64)
        # reduceat misbehaves on empty runs (returns the neighbor, and a
        # trailing empty run indexes OOB); both engines always emit >=1
        # k-mer per signature — keep that invariant explicit
        assert (self.sig_nk > 0).all(), "zero-length signature"
        sig_starts = np.zeros(self.sig_nk.shape[0], dtype=np.int64)
        np.cumsum(self.sig_nk[:-1], out=sig_starts[1:])
        nonempty = (self.kmer_len > 0).astype(np.int64)
        if nonempty.shape[0] == 0:
            return np.zeros(self.sig_nk.shape[0], dtype=np.int64)
        return np.add.reduceat(nonempty, sig_starts)


def _unique_rows(mat: np.ndarray):
    """(unique_rows, inverse) of a uint8 matrix via 1D void unique."""
    n, L = mat.shape
    if n == 0:
        return mat, np.zeros(0, dtype=np.int64)
    v = np.ascontiguousarray(mat).view(f"V{L}").ravel()
    uniq, inv = np.unique(v, return_inverse=True)
    return uniq.view(np.uint8).reshape(-1, L), inv


def _count_extraction(spans: str, stats: dict) -> None:
    """Count a native extraction's blocks and their thread time:
    ``<spans>.extract_blocks``, ``.extract_units`` (the units of work
    they ran as: one a block, or one for each 64 variants of a longer
    block), ``.extract_busy_us`` (the units' microseconds on the threads
    that ran them) and ``.extract_critical_us`` (the longest block's
    wall, first unit to last: the call's critical path).  Busy time over
    the ``<spans>.extract`` span is how many of the library's threads the
    extraction kept busy."""
    for key, n in stats.items():
        count(f"{spans}.extract_{key}", n)


def _iter_extract_batches(cfg: Config, refs, keep_absent: bool,
                          used_out=None, timer=None, owned=None):
    """Yield FlatExtract per EXTRACT_VARS-bounded batch of flushed blocks.

    With ``owned`` (a ``batch_idx -> bool`` predicate, distributed VCF
    passes), yields ``(batch_idx, FlatExtract)`` for owned batches ONLY:
    unowned batches skip the GT step and extraction entirely — batch
    boundaries derive from the cheap record scan alone, so every process
    sees identical numbering.

    The record source is the native scanner (:func:`_scanned_batches`)
    where it takes the file, else the Python path
    (:func:`_python_batches`); either yields its batches as
    ``native.Columns``.  Each batch's scan is the span ``<spans>.scan``,
    where ``spans`` is ``pass2`` for the call phase's pass
    (``keep_absent``) and ``variants`` for the index's."""
    spans = "pass2" if keep_absent else "variants"
    reader = open_variant_reader(cfg.vcf_path, cfg.samples)
    ctx = _GtCtx(reader)
    scan = _open_scan(cfg, reader, ctx, keep_absent)
    if scan is None:
        batches = _python_batches(cfg, reader, ctx, keep_absent, used_out, timer)
    else:
        batches = _scanned_batches(cfg, scan, ctx, keep_absent, used_out, timer)
    refs_of = _RefsOf(refs)
    for b in itertools.count():
        with span(f"{spans}.scan"):
            cols = next(batches, None)
        if cols is None:
            return
        if owned is None or owned(b):
            flat = _extract(cols, cfg, spans, ctx, refs_of)
            yield flat if owned is None else (b, flat)


def _extract(cols, cfg: Config, spans: str, ctx, refs_of) -> FlatExtract:
    """A batch -> FlatExtract: its GT step (:func:`_gt_rows`, the span
    ``<spans>.gt_parse``) and one extraction (``<spans>.extract``), the
    library's or, without it, Python's.  A scanned batch that holds a
    record Python read, or whose GT parse rejects a record, is read again
    by the Python path first (a ``<spans>.scan`` span).
    ``<spans>.batches`` and ``.records`` count the batch and its
    variants, ``.native_records`` or ``.fallback_records`` the variants
    again by the record source that made the batch."""
    gts = None
    if cols.scanned:
        if not cols.fallback:
            with span(f"{spans}.gt_parse"):
                gts = _gt_rows(cols, ctx)
        if gts is None:
            with span(f"{spans}.scan"):
                cols = _reread(cols, cfg, ctx)
    if gts is None:
        with span(f"{spans}.gt_parse"):
            gts = _gt_rows(cols, ctx)
    count(f"{spans}.batches")
    count(f"{spans}.records", cols.n_vars)
    count(f"{spans}.{'native' if cols.scanned else 'fallback'}_records", cols.n_vars)
    with span(f"{spans}.extract"):
        res = native.extract_columns(cols, gts, refs_of, cfg.k, cfg.haploid)
        out = _extract_python(cols, gts, refs_of, cfg) if res is None else res[0]
    if res is not None:
        _count_extraction(spans, res[1])
    return FlatExtract(cols, *out)


def _extract_python(cols, gts, refs_of, cfg: Config) -> tuple:
    """The extraction without the library: ``VB.extract_kmers`` block by
    block over the batch's Variants, which hold their GT rows for this
    call only -> the six flat arrays."""
    rows, a1, a2, ph = gts
    variants = cols.variants()
    for v, r in zip(variants, rows.tolist()):
        if r >= 0:
            v.gt_a1, v.gt_a2, v.phase = a1[r], a2[r], ph[r]
    tgt_var: list[int] = []
    tgt_allele: list[int] = []
    tgt_nsig: list[int] = []
    sig_nk: list[int] = []
    kmer_len: list[int] = []
    chunks: list[bytes] = []
    off = cols.blk_off.tolist()
    for lo, hi, name in zip(off[:-1], off[1:], cols.blk_name):
        vb = VB(cfg.k, float(cfg.error_rate))
        vb.variants = variants[lo:hi]
        for v_idx, per_allele in vb.extract_kmers(refs_of[name], cfg.haploid).items():
            for allele_idx, sigs in per_allele.items():
                tgt_var.append(lo + v_idx)
                tgt_allele.append(allele_idx)
                tgt_nsig.append(len(sigs))
                for sig in sigs:
                    sig_nk.append(len(sig))
                    for kmer in sig:
                        kmer_len.append(len(kmer))
                        chunks.append(kmer)
    for v in variants:
        v.gt_a1 = v.gt_a2 = EMPTY_I32
        v.phase = EMPTY_BOOL
    return (*(np.asarray(x, dtype=np.int32)
              for x in (tgt_var, tgt_allele, tgt_nsig, sig_nk, kmer_len)),
            np.frombuffer(b"".join(chunks), dtype=np.uint8))


class _RefsOf(dict):
    """Each contig's reference by name, as bytes, made once a contig (b""
    where the FASTA lacks it): the native extraction reads it in place
    (one view a contig a batch), the Python one slices it."""

    def __init__(self, refs):
        super().__init__()
        self.refs = refs

    def __missing__(self, name: str) -> bytes:
        ref = self.refs.get(name)
        self[name] = b"" if ref is None else ref.tobytes()
        return self[name]


class _GtCtx:
    """What the record sources and the GT step need of a VCF reader: the
    selected samples, the header's sample count, and whether every
    sample is selected (else Python decodes each record's GT: the
    ploidy-1 wrap-around reads the next SELECTED sample)."""

    __slots__ = ("selected", "n_samples", "whole")

    def __init__(self, reader):
        self.selected = reader.selected
        self.n_samples = len(reader.sample_names)
        self.whole = list(self.selected) == list(range(self.n_samples))


def _gt_rows(cols, ctx: _GtCtx):
    """A batch's GT step -> (rows, a1, a2, phase): ``rows[i]`` is variant
    i's row of genotypes over the selected samples in ``a1``, ``a2``
    (int32) and ``phase`` (bool), -1 where it has none.  The native parse
    (``native.parse_gt_spans``) reads each record's GT column: in place in
    the scanner's text, or from the Python path's records joined into one
    buffer.  Python decodes (``Variant._extract_genotypes``) the Python
    path's records that the parse rejects or does not take: BCF, a
    ``--samples`` subset, every record without the library.  A scanned
    batch whose parse rejects a record gives None (it goes whole to the
    Python path)."""
    has = (cols.gt_at >= 0 if cols.scanned
           else np.array([src is not None for src in cols.gt_src], dtype=bool))
    need = np.flatnonzero(has)
    rows = np.full(cols.n_vars, -1, dtype=np.int64)
    rows[need] = np.arange(need.shape[0])
    if cols.scanned:
        a1, a2, ph, ok = native.parse_gt_spans(cols.buf, cols.gt_off[need], cols.gt_len[need],
                                               cols.gt_at[need], ctx.n_samples)
        return (rows, a1, a2, ph) if ok.all() else None
    srcs = [cols.gt_src[i] for i in need.tolist()]
    cols.gt_src = None  # the records go once their genotypes are rows
    shape = (len(srcs), len(ctx.selected))
    a1, a2, ph = np.empty(shape, np.int32), np.empty(shape, np.int32), np.empty(shape, bool)
    ok = np.zeros(shape[0], dtype=bool)
    at = [r for r, (_, gt_at) in enumerate(srcs) if gt_at >= 0]
    regions = [srcs[r][0]._samples_bytes() for r in at]
    ln = np.fromiter(map(len, regions), np.int64, len(regions))
    res = native.parse_gt_spans(np.frombuffer(b"".join(regions), dtype=np.uint8),
                                np.cumsum(ln) - ln, ln, [srcs[r][1] for r in at], shape[1])
    if res is not None:
        a1[at], a2[at], ph[at], ok[at] = res
    variants = cols.variants()
    for r in np.flatnonzero(~ok).tolist():
        a1[r], a2[r], ph[r] = variants[need[r]]._extract_genotypes(srcs[r][0], ctx.selected)
    return rows, a1, a2, ph


def _open_scan(cfg: Config, reader, ctx: _GtCtx, keep_absent: bool):
    """The native record scanner over the VCF, or None where pass 2 takes
    the Python path: BCF input, a ``--samples`` subset, no library, or a
    file the library cannot take (gzip without zlib)."""
    if not isinstance(reader, VcfReader) or not ctx.whole:
        return None
    scan = native.VcfScan.open(cfg.vcf_path, ctx.n_samples, cfg.freq_key, cfg.uniform,
                               cfg.strip_chr, keep_absent, cfg.k)
    if scan is not None:
        reader.close()
    return scan


def _scanned_batches(cfg: Config, scan, ctx: _GtCtx, keep_absent: bool, used_out, timer):
    """Yield a ``native.Columns`` per extraction batch, one native call
    each; a line the scanner leaves over is read here, as the Python path
    reads it (its InputError included), and given back."""
    beat = 5000
    try:
        while True:
            view = scan.scan(EXTRACT_VARS)
            if view.status == 1:
                v, _ = _make_variant(parse_record(scan.line(), cfg.vcf_path, ctx.n_samples), cfg,
                                     ctx)
                scan.put(v.seq_name, v.has_alts and (keep_absent or v.is_present), v.ref_pos,
                         v.ref_size, v.min_size)
                continue
            if view.status == 2:
                _stream_failed(cfg.vcf_path)
            while timer is not None and beat <= view.n_lines:
                # progress heartbeat with rollback (main.cpp:317-321)
                timer.pelapsed(f"Processed {beat} variants", rollback=True)
                beat += 5000
            batch = scan.batch()
            if used_out is not None:
                used_out.extend(batch.used)
            if batch.n_vars == 0:
                return
            yield batch
    finally:
        scan.close()


def _stream_failed(path: str) -> None:
    """Raise what the Python path raises on a VCF stream the native
    scanner could not inflate: gzip's own error, read again here."""
    import gzip

    with gzip.open(path, "rb") as f:
        while f.read(1 << 24):
            pass
    raise InputError(f"{path}: the gzip stream could not be inflated")


def _reread(sb, cfg: Config, ctx: _GtCtx):
    """A scanned batch read again by the Python path, from its lines, in
    its blocks: the Python path's columns."""
    made = [_make_variant(parse_record(sb.line(i), cfg.vcf_path, ctx.n_samples), cfg, ctx)
            for i in range(sb.n_vars)]
    off = sb.blk_off.tolist()
    blocks = []
    for lo, hi, name in zip(off[:-1], off[1:], sb.blk_name):
        variants, srcs = zip(*made[lo:hi])
        blocks.append((variants, srcs, name))
    return to_columns(blocks)


def _python_batches(cfg: Config, reader, ctx: _GtCtx, keep_absent: bool, used_out, timer):
    """Yield a ``native.Columns`` per extraction batch: whole blocks of
    :func:`_iter_blocks` until EXTRACT_VARS variants."""
    blocks = _iter_blocks(cfg, keep_absent, used_out, timer, reader, ctx)
    while True:
        batch: list = []
        nv = 0
        for block in blocks:
            batch.append(block)
            nv += len(block[0])
            if nv >= EXTRACT_VARS:
                break
        if not batch:
            return
        yield to_columns(batch)


def _make_variant(rec, cfg: Config, ctx: _GtCtx):
    """A record's Variant and its GT source for the batch's GT step
    (:func:`_gt_rows`): ``(record, index of GT in its FORMAT)``, the
    index -1 where Python decodes it, or None where the variant takes no
    GT row.  Everything block structure needs (positions, sizes,
    ``has_alts`` and ``is_present``) is set here."""
    selected = ctx.selected
    if cfg.strip_chr and rec.chrom.startswith("chr"):
        rec.chrom = rec.chrom[3:]
    v = Variant(rec, cfg.freq_key, cfg.uniform)
    if not (v.has_alts and v.is_present):
        return v, None
    fmt = getattr(rec, "fmt", None)  # BCF records decode GT inline
    fmt_keys = fmt.split(":") if fmt is not None else []
    if len(selected) and "GT" in fmt_keys:
        return v, (rec, fmt_keys.index("GT") if ctx.whole else -1)
    # BCF, or no GT data: no GT data clears has_alts
    # (variant.hpp:169-174), which gates BLOCK structure, so it is
    # decided before blocks form
    return v, None if v._extract_genotypes(rec, selected) is None else (rec, -1)


def _iter_blocks(cfg: Config, keep_absent: bool, used_out: list[str] | None,
                 timer: PhaseTimer | None, reader, ctx: _GtCtx):
    """Yield (variants, GT sources, contig) per flushed variant block: the
    contig whose reference the block's extraction takes.

    keep_absent=False mirrors the index phase (skips !is_present records,
    main.cpp:332-333); True mirrors the call phase (main.cpp:539).
    ``used_out`` collects contig names with the reference's exact state
    machine (main.cpp:323-357): the first record's contig always, then a
    new contig only when a block flush observes the change — a contig
    whose single passing variant never triggers a flush is *not* recorded
    (upstream quirk, kept).
    """
    block: list = []
    srcs: list = []
    last_seq_name = None
    for i, rec in enumerate(reader, 1):
        v, src = _make_variant(rec, cfg, ctx)
        if timer is not None and i % 5000 == 0:
            # progress heartbeat with rollback (main.cpp:317-321)
            timer.pelapsed(f"Processed {i} variants", rollback=True)
        if last_seq_name is None:
            last_seq_name = v.seq_name
            if used_out is not None:
                used_out.append(last_seq_name)
        if not v.has_alts or (not keep_absent and not v.is_present):
            continue
        if block and (not are_near(block[-1], v, cfg.k) or last_seq_name != v.seq_name):
            yield block, srcs, last_seq_name
            block, srcs = [], []
            if last_seq_name != v.seq_name:
                last_seq_name = v.seq_name
                if used_out is not None:
                    used_out.append(last_seq_name)
        block.append(v)
        srcs.append(src)
    if block:
        yield block, srcs, last_seq_name


def save_index(index: Index, path: str, cfg: Config | None = None) -> None:
    st = _index_state(index)
    _add_meta(st, cfg)
    _save_state(st, path)


def _add_meta(st: dict, cfg: Config | None) -> None:
    if cfg is None:
        return
    import json

    st["meta_json"] = np.frombuffer(
        json.dumps(index_fingerprint(cfg), default=str).encode(),
        dtype=np.uint8,
    )


def save_index_async(index: Index, path: str, cfg: Config | None = None):
    """Write a freshly BUILT index in a background thread (the write
    overlaps the call phase in `run`).  Counter planes are snapshotted as
    zeros — they are zero right after build, and the call phase mutates
    them in place, while a saved index must carry pristine counters.
    Returns the thread (join before exiting); write failures log one
    stderr line (the in-memory index is still good)."""
    import threading

    st = _index_state(index)
    _add_meta(st, cfg)
    for k in ("bf_counts", "ctx_counts", "kmap_vals"):
        if k in st:
            st[k] = np.zeros_like(st[k])

    def write():
        try:
            _save_state(st, path)
        except OSError as e:
            print(f"[malva-tpu] index not saved ({e}); continuing",
                  file=sys.stderr)

    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


_INDEX_META_FIELDS = ("bf_size", "samples", "freq_key", "uniform",
                      "haploid", "strip_chr", "fasta_path")


def _index_state(index: Index) -> dict:
    st = {}
    for name, obj in [("bf", index.bf), ("ctx", index.context_bf)]:
        for k, v in obj.state().items():
            st[f"{name}_{k}"] = v
    for k, v in index.ref_bf.state().items():
        st[f"kmap_{k}"] = v
    return st


def index_fingerprint(cfg: Config) -> dict:
    """The config fields that change index CONTENT (beyond the k/ref_k
    already encoded in the file name): Bloom geometry, sample subset,
    frequency key and flags that gate which k-mers are inserted."""
    return {f: getattr(cfg, f) for f in _INDEX_META_FIELDS}


def index_matches_config(path: str, cfg: Config):
    """(ok, why): whether a persisted index's fingerprint matches this
    run's config.  Index files predating the fingerprint (or external
    .zst imports) return ok — the caller keeps the upstream
    name-only contract for those."""
    import json
    import zipfile

    try:
        with zipfile.ZipFile(path) as zf:
            if "meta_json.npy" not in zf.namelist():
                return True, "no fingerprint (pre-round-5 index)"
            import io as _io

            arr = np.lib.format.read_array(
                _io.BytesIO(zf.read("meta_json.npy")), allow_pickle=False
            )
            meta = json.loads(bytes(arr).decode())
    except Exception as e:  # unreadable file: let load_index report it
        return True, f"fingerprint unreadable ({e})"
    want = index_fingerprint(cfg)
    for f, v in want.items():
        if f in meta and meta[f] != v:
            return False, f"{f}: {meta[f]!r} != {v!r}"
    return True, "match"


def _save_state(st: dict, path: str) -> None:
    # The Bloom word arrays are GiB-sized and mostly zero at any realistic
    # fill; zlib-inflating them dominated index load (23 s for a -b 1 pair
    # at chr scale).  Store them sparse (nonzero index + value), and write
    # the npz with per-member compression: the sparse word members STORED
    # (high-entropy, incompressible), everything else (kmap_keys is
    # ~270 MB of ACGT text at chr scale) DEFLATED at level 1.
    out = {}
    stored = set()
    for k, v in st.items():
        if k.endswith("_words"):
            nz = np.flatnonzero(v)
            out[k + "_nz"] = nz.astype(np.int64)
            out[k + "_nzv"] = np.asarray(v)[nz]
            out[k + "_len"] = np.int64(v.shape[0])
            stored.update((k + "_nz", k + "_nzv", k + "_len"))
        else:
            out[k] = v
    _write_npz_mixed(path, out, stored)


def _write_npz_mixed(path: str, arrays: dict, stored: set) -> None:
    """npz writer with per-member compression (numpy's savez is all-or-
    nothing).  np.load reads the result like any other npz."""
    import io
    import zipfile

    if not path.endswith(".npz"):
        path += ".npz"
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", allowZip64=True) as zf:
        for name, arr in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asarray(arr), allow_pickle=False)
            if name in stored:
                zf.writestr(name + ".npy", buf.getvalue(),
                            compress_type=zipfile.ZIP_STORED)
            else:
                zf.writestr(name + ".npy", buf.getvalue(),
                            compress_type=zipfile.ZIP_DEFLATED, compresslevel=1)
    os.replace(tmp, path)  # atomic: a crashed writer leaves no index


def load_index(path: str) -> Index:
    import zipfile

    try:
        raw = dict(np.load(path))
        return _index_from_raw(raw)
    except (zipfile.BadZipFile, KeyError, ValueError, EOFError, OSError) as e:
        if isinstance(e, FileNotFoundError):
            raise
        raise InputError(
            f"{path}: not a valid malva index (truncated or corrupt: {e}); "
            f"re-run `malva-tpu index`"
        ) from e


def _index_from_raw(raw: dict) -> Index:
    st = {}
    for k, v in raw.items():
        if k.endswith("_words_nz"):
            base = k[: -len("_nz")]
            nzv = raw[base + "_nzv"]
            dense = np.zeros(int(raw[base + "_len"]), dtype=nzv.dtype)
            dense[v] = nzv
            st[base] = dense
        elif k.endswith("_words_nzv") or k.endswith("_words_len"):
            continue
        else:
            st[k] = v  # incl. dense "_words" from pre-sparse index files
    return Index(
        bf=BF.from_state(st, "bf_"),
        context_bf=BF.from_state(st, "ctx_"),
        ref_bf=KMAP.from_state(st, "kmap_"),
    )


def apply_sample_counts(
    index: Index, contexts: np.ndarray, counts: np.ndarray, cfg: Config
) -> None:
    """KMC-scan equivalent (main.cpp:487-500): for each distinct canonical
    context, add its count to the exact map always and to the alt Bloom
    filter only when the context is not a known reference context.

    ``contexts`` may be 2-bit packed uint64 rows (the counter's output
    contract: canonical, pure-ACGT) — those take the fused native path
    (no ASCII matrices ever materialize); ASCII rows (external dumps, may
    be non-canonical / non-ACGT) take the general path."""
    if contexts.dtype == np.uint64 and _apply_packed_host(
        index, contexts, counts, cfg
    ):
        return
    contexts = _as_ascii(contexts, cfg.ref_k)
    off = cfg.center_off
    centers = np.ascontiguousarray(contexts[:, off : off + cfg.k])
    index.ref_bf.increment_keys(centers, counts)
    ctx_known = index.context_bf.test_keys(contexts)
    sel = ~ctx_known
    index.bf.increment_keys(centers[sel], counts[sel])


def _apply_packed_host(
    index: Index, packed: np.ndarray, counts: np.ndarray, cfg: Config
) -> bool:
    """Packed fast path of :func:`apply_sample_counts`: one fused native
    pass computes (context hash, canonical-center hash, packed canonical
    center) per row; the Bloom updates run on hashes and the exact-map
    increments on packed binary search.  Returns False when the native
    library is unavailable (caller falls back to the ASCII path)."""
    res = native.apply_ctx_packed(packed, cfg.ref_k, cfg.k)
    if res is None:
        return False
    ctx_h, cen_h, cen_pk = res
    if not index.ref_bf.increment_packed(cen_pk, counts, cfg.k):
        return False
    if native.bf_apply_hashed(index.context_bf, index.bf, ctx_h, cen_h, counts):
        return True  # fused ctx-test + counter increment, one native pass
    ctx_known = index.context_bf.test_hashed(ctx_h)
    sel = ~ctx_known
    index.bf.increment_hashed(cen_h[sel], np.asarray(counts)[sel])
    return True


def _set_coverages_flat(index: Index, flat: FlatExtract) -> None:
    """main.cpp:151-184 over a FlatExtract batch: per-allele coverage =
    max over signatures of the incremental integer mean of the nonzero
    k-mer counts.  Queries are issued as one batch per (is_ref, length)
    over the UNIQUE k-mers; the sequential mean/max scan runs in the
    native kernel (malva_coverage)."""
    w_flat = np.zeros(flat.n_slots, dtype=np.int64)
    for is_ref, _L, idxs, mat in flat.length_groups():
        uarr, inv = _unique_rows(mat)
        vals = (
            index.ref_bf.get_counts(uarr)
            if is_ref
            else index.bf.get_counts(uarr).astype(np.int64)
        )
        w_flat[flat.slots(idxs)] = vals[inv]
    _scan_and_assign(w_flat, flat)


def _scan_and_assign(w_flat: np.ndarray, flat: FlatExtract) -> None:
    """Mean/max coverage scan over resolved k-mer weights + write-back
    into the Variant objects (main.cpp:162-181 semantics)."""
    sl = flat.sig_lens()
    an = np.asarray(flat.tgt_nsig, dtype=np.int64)
    cov = native.coverage(w_flat, sl, an)
    if cov is None:  # pure-Python mirror of csrc/host_kernels.cpp
        cov = np.zeros(an.shape[0], dtype=np.int64)
        sig_off = np.concatenate([[0], np.cumsum(sl)])
        s = 0
        for a, nsig in enumerate(an.tolist()):
            best = 0
            for _ in range(nsig):
                curr = 0
                n = 0
                for w in w_flat[sig_off[s] : sig_off[s + 1]].tolist():
                    if w > 0:
                        curr = (curr * n + w) // (n + 1)
                        n += 1
                s += 1
                if curr > best:
                    best = curr
            cov[a] = best
    all_vars = flat.all_vars
    for vi, ai, c in zip(flat.tgt_var.tolist(), flat.tgt_allele.tolist(),
                         cov.tolist()):
        if ai >= 0:
            all_vars[vi].set_coverage(ai, c)


def _flat_query_info(index: Index, flat: FlatExtract) -> list:
    """Sample-independent resolution of a FlatExtract's unique queries:
    Bloom bit/rank lookups, exact-map slot lookups — everything that does
    NOT touch counter values.  Batch mode runs this once per group and
    answers each sample from its counter PLANE (uint16 BF counters +
    uint32 KMAP values, see call_batch)."""
    qs = []
    for is_ref, _L, idxs, mat in flat.length_groups():
        uarr, inv = _unique_rows(mat)
        slots_a = flat.slots(idxs)
        if is_ref:
            found, kslot = index.ref_bf.get_slots(uarr)
            qs.append((True, slots_a, inv, found, kslot))
        else:
            is_set, cnt_idx = index.bf.count_slots(uarr)
            qs.append((False, slots_a, inv, is_set, cnt_idx))
    return [qs, flat.n_slots]


def _weights_from_planes(qinfo: list, bf_plane: np.ndarray,
                         kmap_plane: np.ndarray) -> np.ndarray:
    """Per-sample weight assembly from a resolved query set: gather the
    plane values (BF counters mod 2^16; KMAP values reinterpreted signed,
    as KMAP.get_counts does)."""
    qs, slot = qinfo
    w_flat = np.zeros(slot, dtype=np.int64)
    for is_ref, slots_a, uidx_a, found, idx in qs:
        vals = np.zeros(found.shape[0], dtype=np.int64)
        if is_ref:
            vals[found] = kmap_plane[idx[found]].astype(np.int32)
        else:
            vals[found] = bf_plane[idx[found]]
        w_flat[slots_a] = vals[uidx_a]
    return w_flat


def _prefetch(it, spans: str, depth: int = 2, gate=None):
    """Run an iterator in a background thread with a bounded queue: the
    spill merge (disk reads + native sort/merge, GIL-released) overlaps
    the counter application (native scatter/search) instead of
    serializing bucket-by-bucket.

    The worker starts EAGERLY (on call, not on first next()): callers
    create the pass-2 extraction pipeline before the counting phase so
    its producer packs otherwise-idle cycles (extraction never reads the
    counter planes, only `_set_coverages_flat` on the consumer side
    does).  With a ``gate`` (a ``threading.Event``) the worker makes its
    next item only while the gate is set (see :func:`_held`).

    The caller names the spans, one an item: the worker's
    ``<spans>.put_wait`` (its put, which waits while the queue is full)
    and ``<spans>.held`` (at the gate), the consumer's ``<spans>.wait``
    (its get); the worker's spans are children of what the caller has
    open."""
    import queue

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    err: list = []

    def worker():
        try:
            for x in it:
                with span(f"{spans}.put_wait"):
                    q.put(x)
                if gate is not None:
                    with span(f"{spans}.held"):
                        gate.wait()
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            q.put(done)

    t = threading.Thread(target=carried(worker), daemon=True)
    t.start()

    def gen():
        while True:
            with span(f"{spans}.wait"):
                x = q.get()
            if x is done:
                break
            yield x
        t.join()
        if err:
            raise err[0]

    return gen()


@contextlib.contextmanager
def _held(gate):
    """Hold the producer of a gated :func:`_prefetch` at its next item for
    the block: the one-device upload's host work (the bucket table) ran
    2-3x slower beside pass 2's extraction on every core (PERF.md)."""
    gate.clear()
    try:
        yield
    finally:
        gate.set()


def _kmc_batches(cfg: Config, path: str):
    """Stream an external KMC artifact (text dump or binary DB) as
    (contexts_ascii, counts) batches — never materializing the distinct
    set (a WGS dump/database is tens of GB)."""
    if cfg.from_kmc_dump:
        from .count.counter import iter_kmc_dump

        return iter_kmc_dump(path, cfg.ref_k)
    from .io.kmc import iter_kmc_db, read_kmc_pre

    _, info = read_kmc_pre(path)
    if info["kmer_length"] != cfg.ref_k:
        raise InputError(
            f"KMC database k={info['kmer_length']} != ref_k {cfg.ref_k}"
        )
    return iter_kmc_db(path)


def _kmc_est_kmers(cfg: Config, path: str) -> int:
    """Estimated k-mer count of an external KMC artifact (device routing)."""
    if cfg.from_kmc_db:
        from .io.kmc import read_kmc_pre

        return int(read_kmc_pre(path)[1]["total_kmers"])
    try:
        return os.path.getsize(path) // (cfg.ref_k + 4)
    except OSError:
        return 0


def _as_ascii(contexts: np.ndarray, ref_k: int) -> np.ndarray:
    from .ops.seq import unpack_2bit

    return unpack_2bit(contexts, ref_k) if contexts.dtype == np.uint64 else contexts


def _genotype_and_emit(cfg: Config, index: Index, refs, out,
                       timer: PhaseTimer, batches=None) -> None:
    reader = open_variant_reader(cfg.vcf_path, cfg.samples)
    out.write(cleaned_header(reader.meta_lines, cfg.verbose))

    n = 0
    # prefetch: the producer side (record scan + GT parse + native
    # extraction) overlaps the consumer side (coverage queries +
    # genotyping + formatting) — both halves spend most of their time in
    # GIL-releasing native kernels, so the Python halves hide behind
    # them.  ``batches`` may be a prefetch started earlier (call() hands
    # one over so extraction overlaps the counting phase too).
    if batches is None:
        batches = _prefetch(_iter_extract_batches(cfg, refs, keep_absent=True), "pass2")
    # the exact map's sorted key view, which coverage searches, is built
    # while the producer makes the first batch
    with span("pass2.kmap_view"):
        index.ref_bf.key_view()
    for flat in batches:
        with span("pass2.coverage"):
            _set_coverages_flat(index, flat)
        with span("pass2.genotype"):
            genotype_block(flat.all_vars, cfg.max_coverage, cfg.haploid,
                           cfg.error_rate)
        with span("pass2.format"):
            for line in format_variants(flat.all_vars, cfg.haploid, cfg.verbose):
                out.write(line + "\n")
        n += len(flat.all_vars)
    timer.pelapsed(f"VCF parsing and genotyping ({n} variants)")


def _reset_counters(index: Index) -> None:
    index.bf.counts[:] = 0
    for k in index.ref_bf.kmers:
        index.ref_bf.kmers[k] = 0



def _route(cfg: Config, work: int | None, floor: int, device=None, mesh=None, cards=None):
    """``(mesh, None)`` for the sharded device path, ``(None, device)``
    for one torch device, ``(None, None)`` for the host.  An explicit
    ``mesh`` or ``device`` is taken as given; with neither, the backend
    and the work size decide (backend.py).  Where the route is the mesh,
    ``cards`` (``backend.start_cards``'s thread, or None) is joined."""
    m = None if mesh is None and device is not None else mesh_for(cfg, work, floor, mesh)
    if m is None:
        return None, device_for(cfg, work, floor, device)
    if cards is not None:
        cards.join()
    return m, None


def _count_device(device=None, mesh=None):
    """The explicit device of the sample counting: the mesh's first one."""
    return mesh[0] if mesh is not None else device


def _log_stats(stats: dict | None) -> None:
    """Log a device call step's stats; after a sharded one, the mesh's
    device memory goes back to the cards first (``release``)."""
    if stats is not None and "shards" in stats:
        from .parallel.sharded_index import log_sharded_step, release

        release(stats)
        log_sharded_step(stats)
    elif stats is not None:
        from .index.device import log_step_rate

        log_step_rate(stats)


def build_index(cfg: Config, timer: PhaseTimer | None = None, device=None,
                mesh=None) -> Index:
    """malva_tpu.pipeline.build_index with the context scan on a torch
    device or sharded over a mesh when the backend resolves to one (or
    ``device`` or ``mesh`` is given)."""
    timer = timer or PhaseTimer(TAG)
    refs = load_reference(cfg.fasta_path, cfg.strip_chr)
    timer.pelapsed("Reference processed")
    cards = start_cards(cfg, device, mesh)

    bf = BF(cfg.bf_size)
    ref_bf = KMAP()
    context_bf = BF(cfg.bf_size)
    used_names: list[str] = []
    n_vars = 0
    for flat in _iter_extract_batches(cfg, refs, keep_absent=False,
                                      used_out=used_names, timer=timer):
        n_vars += flat.n_vars
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
    m, dev = _route(cfg, total_ref, DEVICE_MIN_REF_POSITIONS, device, mesh, cards)
    refs_used = [refs[n] for n in used_names if n in refs and len(refs[n]) > 0]
    if m is not None:
        from .parallel.sharded_index import build_context_sharded

        build_context_sharded(index, refs_used, cfg, m)
        timer.pelapsed(f"Reference BF creation complete (sharded over {len(m)} shards)")
    elif dev is not None:
        from .index.device import build_context_device

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
    # pass-2 extraction overlaps the counting phase (pipeline.py:842-852),
    # and waits while the in-RAM branch's device call step runs
    pass2_depth = int(os.environ.get("MALVA_PASS2_PREFETCH", 8 if cfg.spill_dir else 32))
    gate = threading.Event()
    gate.set()
    pass2 = _prefetch(_iter_extract_batches(cfg, refs, keep_absent=True), "pass2",
                      depth=pass2_depth, gate=gate)
    stats = None
    cards = start_cards(cfg, device, mesh)

    if cfg.spill_dir and not (cfg.from_kmc_dump or cfg.from_kmc_db):
        from .count.spill import count_reads_kmers_spill

        m, dev = _route(cfg, _file_size(cfg.sample_path), DEVICE_MIN_READ_BYTES, device, mesh,
                        cards)
        batches = count_reads_kmers_spill(cfg.sample_path, cfg.ref_k, cfg.spill_dir,
                                          device=m[0] if m is not None else dev)
        if m is not None:
            from .parallel.sharded_index import apply_sample_counts_sharded_stream

            stats = apply_sample_counts_sharded_stream(index, _prefetch(batches, "spill"), cfg, m)
        elif dev is not None:
            from .index.device import apply_sample_counts_stream

            stats = apply_sample_counts_stream(index, _prefetch(batches, "spill"), cfg, dev)
        else:
            for keys, cnts in _prefetch(batches, "spill"):
                apply_sample_counts(index, keys, cnts, cfg)
        timer.pelapsed("Sample k-mer counting + BF weights (spill)")
    elif cfg.from_kmc_dump or cfg.from_kmc_db:
        stats = _apply_kmc_stream(cfg, index, cfg.sample_path,
                                  *_kmc_route(cfg, cfg.sample_path, device, mesh, cards))
        timer.pelapsed("Sample k-mer stream + BF weights")
    else:
        contexts, counts = _sample_kmers(cfg, cfg.sample_path, _count_device(device, mesh))
        timer.pelapsed("Sample k-mer counting")
        m, dev = _route(cfg, contexts.shape[0], DEVICE_MIN_KMERS, device, mesh, cards)
        if m is not None:
            from .parallel.sharded_index import apply_sample_counts_sharded_stream

            with _held(gate):
                stats = apply_sample_counts_sharded_stream(index, [(contexts, counts)], cfg, m)
        elif dev is not None:
            from .index.device import apply_sample_counts_device

            with _held(gate):
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
        from .io.kmc import load_kmc_db

        return load_kmc_db(path, cfg.ref_k)
    dev = device_for(cfg, _file_size(path), DEVICE_MIN_READ_BYTES, device)
    return count_reads_kmers(path, cfg.ref_k, device=dev, return_packed=True)


def _kmc_route(cfg: Config, path: str, device=None, mesh=None, cards=None):
    """(mesh, device) of an external KMC artifact's call step, routed by
    its estimated k-mer count (see :func:`_route`)."""
    return _route(cfg, _kmc_est_kmers(cfg, path), DEVICE_MIN_KMERS, device, mesh, cards)


def _apply_kmc_stream(cfg: Config, index: Index, path: str, mesh, target,
                      dev: DeviceIndex | None = None, sharded=None) -> dict | None:
    """Stream an external KMC artifact through the call step sharded over
    ``mesh`` (reusing ``sharded`` when given), on ``target`` (reusing
    ``dev``), or through the host apply when both are None; the step's
    stats, or None on the host."""
    batches = _kmc_batches(cfg, path)
    if mesh is not None:
        from .parallel.sharded_index import apply_sample_counts_sharded_stream

        return apply_sample_counts_sharded_stream(index, batches, cfg, mesh, sharded=sharded)
    if target is not None:
        from .index.device import apply_sample_counts_stream

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
    every sample from its plane (the host helpers of malva_tpu's
    call_batch, copied unchanged).
    The index's counter state is unspecified after this returns."""
    timer = timer or PhaseTimer(TAG)
    refs = load_reference(cfg.fasta_path, cfg.strip_chr)
    timer.pelapsed("Reference processed")

    dev = sharded = None
    planes: list[tuple[np.ndarray, np.ndarray]] = []
    cards = start_cards(cfg, device, mesh)
    for i, sample_path in enumerate(sample_paths):
        _reset_counters(index)
        kmc = cfg.from_kmc_dump or cfg.from_kmc_db
        if kmc:
            m, target = _kmc_route(cfg, sample_path, device, mesh, cards)
        else:
            contexts, counts = _sample_kmers(cfg, sample_path, _count_device(device, mesh))
            m, target = _route(cfg, contexts.shape[0], DEVICE_MIN_KMERS, device, mesh, cards)
        if m is not None and sharded is None:
            from .parallel.sharded_index import shard_index_routed

            sharded = shard_index_routed(index, cfg, m)
            print(f"[{TAG}] sharded index uploaded to {len(m)} shards once for "
                  f"{len(sample_paths)} samples", file=sys.stderr)
        if target is not None and dev is None:
            from .index.device import DeviceIndex

            dev = DeviceIndex.from_host(index, cfg, target)
            print(f"[{TAG}] device index uploaded to {target} once for "
                  f"{len(sample_paths)} samples", file=sys.stderr)
        if kmc:
            stats = _apply_kmc_stream(cfg, index, sample_path, m, target, dev=dev,
                                      sharded=sharded)
        elif m is not None:
            from .parallel.sharded_index import apply_sample_counts_sharded_stream

            stats = apply_sample_counts_sharded_stream(index, [(contexts, counts)], cfg, m,
                                                       sharded=sharded)
        elif target is not None:
            from .index.device import apply_sample_counts_device

            stats = apply_sample_counts_device(index, contexts, counts, cfg, target, dev=dev)
        else:
            stats = None
            apply_sample_counts(index, contexts, counts, cfg)
        if i == len(sample_paths) - 1:
            sharded = None  # the last sample: its tensors go before the VCFs are written
        _log_stats(stats)
        planes.append((index.bf.counts.astype(np.uint16),  # truncation == mod 2^16
                       index.ref_bf.snapshot_values()))
        timer.pelapsed(f"Counters ready: {sample_path}")

    reader = open_variant_reader(cfg.vcf_path, cfg.samples)
    header = cleaned_header(reader.meta_lines, cfg.verbose)
    for out in outs:
        out.write(header)
    n = 0
    for flat in _prefetch(_iter_extract_batches(cfg, refs, keep_absent=True), "pass2"):
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
