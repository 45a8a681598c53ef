"""Command line: ``malva-tpu-torch index | call | run | batch``.

The port's copy of ``malva_tpu/cli.py``: the same flags, config, index
persistence and overlapped counting producer.  ``--backend`` takes
``auto | host | cuda``.  ``run`` starts the producer (``python -m
malva_tpu_torch.count.spill``, host only) only where ``malva_tpu`` would,
and not for reads that route to the card, which counts them inline after
the index phase.  ``--profile-dir`` writes a ``torch.profiler`` trace of
the command (CPU, and CUDA on a card) into that directory when it ends,
with each of the program's spans as a range on its host timeline.  Each
command ends with one stderr line, ``[malva-tpu-torch/spans] <json>``:
its spans and counters (``utils/timing.py PhaseTimer.spans_line``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .backend import BACKENDS, resolve
from .pipeline import (
    DEVICE_MIN_READ_BYTES,
    TAG,
    _file_size,
    build_index,
    call,
    call_batch,
    index_matches_config,
    load_index,
    save_index,
    save_index_async,
)
from .utils.config import Config
from .utils.timing import PhaseTimer, span


def _parser(prog: str = TAG) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, add_help=True)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("index", "call", "run", "batch"):
        sp = sub.add_parser(name)
        sp.add_argument("-k", "--kmer-size", type=int, default=35)
        sp.add_argument("-r", "--ref-kmer-size", type=int, default=43)
        sp.add_argument("-e", "--error-rate", type=float, default=0.001)
        sp.add_argument("-s", "--samples", default="-")
        sp.add_argument("-f", "--freq-key", default="AF")
        sp.add_argument("-c", "--max-coverage", type=int, default=200)
        sp.add_argument("-b", "--bf-size", type=int, default=4, help="bloom filter size in GB")
        sp.add_argument("-p", "--strip-chr", action="store_true")
        sp.add_argument("-u", "--uniform", action="store_true")
        sp.add_argument("-v", "--verbose", action="store_true")
        sp.add_argument("-1", "--haploid", action="store_true", dest="haploid")
        sp.add_argument("--from-kmc-dump", action="store_true",
                        help="treat <sample> as kmc_dump text (KMER<TAB>COUNT)")
        sp.add_argument("--from-kmc", action="store_true", dest="from_kmc_db",
                        help="treat <sample> as a KMC database prefix (.kmc_pre/.kmc_suf)")
        sp.add_argument("--spill-dir", default="",
                        help="bounded-memory counting: spill distinct k-mers "
                             "to this directory (kmc -m4 parity; resumable)")
        sp.add_argument("--backend", default="auto", choices=BACKENDS,
                        help="where the device work runs (auto routes by size)")
        sp.add_argument("--malvax", action="store_true",
                        help="read/write the reference .malvax.zst index format")
        sp.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace into this directory")
        sp.add_argument("reference")
        sp.add_argument("variants")
        if name == "batch":
            sp.add_argument("sample", nargs="+", help="reads files, FASTA/FASTQ (.gz ok)")
            sp.add_argument("-o", "--out-dir", default=".", help="output directory for per-sample VCFs")
        else:
            sp.add_argument("sample", help="reads file, FASTA/FASTQ (.gz ok)")
    return p


def _config(args: argparse.Namespace) -> Config:
    sample = args.sample[0] if isinstance(args.sample, list) else args.sample
    return Config(
        fasta_path=args.reference,
        vcf_path=args.variants,
        sample_path=sample,
        k=args.kmer_size,
        ref_k=args.ref_kmer_size,
        error_rate=np.float32(args.error_rate),
        samples=args.samples,
        freq_key=args.freq_key,
        max_coverage=args.max_coverage,
        bf_size=Config.bf_gb_to_bits(args.bf_size),
        strip_chr=args.strip_chr,
        from_kmc_dump=args.from_kmc_dump,
        from_kmc_db=args.from_kmc_db,
        spill_dir=args.spill_dir,
        backend=args.backend,
        uniform=args.uniform,
        verbose=args.verbose,
        haploid=args.haploid,
    )


def _overlaps_counting(cfg: Config) -> bool:
    """Whether ``run`` may count on a host producer: not when the reads
    route to the card, which counts them (malva_tpu/cli.py:277).  An
    explicit ``cuda`` routes them there without asking CUDA: asking would
    start CUDA on every card on this thread before the index pass, where
    the cards of a mesh start in a background thread instead
    (``backend.start_cards``); without a card, ``cuda`` raises at the
    index's route."""
    return cfg.backend != "cuda" and resolve(cfg, _file_size(cfg.sample_path),
                                              DEVICE_MIN_READ_BYTES) != "cuda"


def _start_count_producer(cfg: Config):
    """Launch the spill-counting producer for the overlapped ``run``, or
    None when overlap does not apply (KMC input, small reads, counting on
    the card, or MALVA_NO_OVERLAP=1).  Returns (Popen, spill_dir,
    spill_dir_is_temporary)."""
    import subprocess

    if os.environ.get("MALVA_NO_OVERLAP"):
        return None
    if cfg.from_kmc_dump or cfg.from_kmc_db:
        return None
    try:
        nbytes = os.path.getsize(cfg.sample_path)
    except OSError:
        return None  # missing reads surface as the call phase's error
    # reads below this size count inline: the helper-process + disk-spill
    # overhead outweighs the overlap win
    if nbytes < int(os.environ.get("MALVA_OVERLAP_MIN_BYTES", 32 << 20)):
        return None
    if not _overlaps_counting(cfg):
        return None
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    is_tmp = not cfg.spill_dir
    spill_dir = cfg.spill_dir or _auto_spill_dir(nbytes)
    p = subprocess.Popen(
        [sys.executable, "-m", "malva_tpu_torch.count.spill",
         cfg.sample_path, str(cfg.ref_k), spill_dir],
        env=env, stdout=subprocess.DEVNULL,  # parent stdout is pure VCF
    )
    print(f"[{TAG}] counting overlapped with index build (spill {spill_dir})", file=sys.stderr)
    return (p, spill_dir, is_tmp)


def _auto_spill_dir(reads_bytes: int) -> str:
    """Temp spill directory for the overlapped ``run``'s counting helper.

    Prefers /dev/shm when the spill's upper bound fits comfortably: tmpfs
    writes several times faster than a throttled block device.  Spill
    volume is bounded by ~20 bytes per k-mer occurrence =~ 10x the FASTQ
    byte size; require 2x that bound free so the gate stays conservative.
    The bound is taken from the file's size on disk, also for gzip reads,
    whose spill it underestimates (malva_tpu sizes it the same way; an
    ENOSPC there fails the producer and ``run`` recounts inline).
    Explicit --spill-dir is never overridden (bounded-memory runs belong
    on disk), and MALVA_SPILL_SHM=0 opts out."""
    import tempfile

    shm = "/dev/shm"
    if os.environ.get("MALVA_SPILL_SHM", "1") != "0":
        try:
            st = os.statvfs(shm)
            avail = st.f_bavail * st.f_frsize
            if reads_bytes * 20 < avail and os.access(shm, os.W_OK):
                return tempfile.mkdtemp(prefix="malva_spill_", dir=shm)
        except OSError:
            pass
    return tempfile.mkdtemp(prefix="malva_spill_")


def _finish_count_producer(producer, cfg: Config, timer: PhaseTimer) -> None:
    """Join the producer; on success the call phase consumes its spill
    store (resume skips straight to the merge), on failure fall back to
    inline counting (correctness never depends on the overlap)."""
    p, spill_dir, is_tmp = producer
    rc = p.wait()
    if rc != 0:
        print(f"[{TAG}] overlapped counting failed (rc={rc}); recounting inline",
              file=sys.stderr)
        if is_tmp:
            import shutil

            shutil.rmtree(spill_dir, ignore_errors=True)
        return
    cfg.spill_dir = spill_dir
    timer.pelapsed("Sample k-mer counting (overlapped with index phase)")


def _try_save_index(index, path: str, cfg: Config, timer: PhaseTimer) -> None:
    """Persist the index ``run``/``batch`` just built so consecutive runs
    can reuse it.  Save failure is not fatal: the in-memory index is
    still good."""
    try:
        save_index(index, path, cfg)
        timer.pelapsed("Index saved")
    except OSError as e:
        print(f"[{TAG}] index not saved ({e}); continuing", file=sys.stderr)


class _Profile:
    """torch.profiler over the whole command; the trace is exported into
    ``trace_dir`` when the command ends (jax.profiler.start_trace's
    counterpart in malva_tpu/cli.py:117-124)."""

    def __init__(self, trace_dir: str):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.dir, self.prof = trace_dir, profile(activities=acts)
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"{TAG}.{os.getpid()}.pt.trace.json")
        self.prof.export_chrome_trace(path)
        print(f"[{TAG}] torch.profiler trace -> {path}", file=sys.stderr)


def main(argv: list[str] | None = None, out=None) -> int:
    """Dispatch with malva_tpu.cli.main's one-line ``ERROR:`` contract for
    bad inputs.  The VCF goes to ``out`` (stdout by default)."""
    import gzip
    import struct
    import zipfile

    from .utils.errors import InputError

    out = out if out is not None else sys.stdout
    try:
        return _main(argv, out)
    except (InputError, OSError, EOFError, struct.error,
            zipfile.BadZipFile, gzip.BadGzipFile, UnicodeDecodeError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


def _main(argv: list[str] | None, out) -> int:
    from .utils.native import tune_malloc

    tune_malloc()
    args = _parser().parse_args(argv)
    cfg = _config(args)
    timer = PhaseTimer(TAG, out=sys.stderr)
    prof = _Profile(args.profile_dir) if args.profile_dir else None
    try:
        with timer.recording(profiling=prof is not None):
            rc = _dispatch(args, cfg, timer, out)
    finally:
        if prof is not None:
            prof.stop()
    # the process's own end, so that a caller can split its exit (the
    # interpreter's and CUDA's teardown) from the last phase
    out.flush()
    print(f"[{TAG}/spans] {timer.spans_line()}", file=sys.stderr)
    print(f"[{TAG}/metrics] main returned at {time.time():.6f} s (epoch); the process exits "
          f"after", file=sys.stderr, flush=True)
    return rc


def _dispatch(args, cfg: Config, timer: PhaseTimer, out) -> int:
    if args.cmd == "index":
        index = build_index(cfg, timer)
        if args.malvax:
            from .io.malvax import write_malvax

            write_malvax(index, cfg.index_path().replace(".malvax.npz", ".malvax.zst"))
        else:
            save_index(index, cfg.index_path(), cfg)
        timer.pelapsed("Index saved")
        return 0

    if args.cmd == "call":
        if args.malvax:
            from .io.malvax import read_malvax
            from .pipeline import Index

            bf, km, ctx = read_malvax(cfg.index_path().replace(".malvax.npz", ".malvax.zst"))
            index = Index(bf=bf, ref_bf=km, context_bf=ctx)
        else:
            path = cfg.index_path()
            if not os.path.exists(path):
                print(f"ERROR: index file {path} not found (run `index` first)", file=sys.stderr)
                return 1
            with span("index.load"):
                index = load_index(path)
        timer.pelapsed("Index loaded")
        call(cfg, index, out, timer)
        return 0

    if args.cmd == "batch":
        return _batch(args, cfg, timer)

    # run: reuse a persisted index whose fingerprint matches, else build it,
    # with the counting producer overlapped where malva_tpu overlaps it
    # (malva_tpu/cli.py:196-252)
    path = cfg.index_path()
    producer = saver = None
    index = _reusable_index(cfg)
    if index is None:
        try:
            producer = _start_count_producer(cfg)
            index = build_index(cfg, timer)
        except BaseException:
            if producer is not None:
                producer[0].kill()
                producer[0].wait()
                if producer[2]:
                    import shutil

                    shutil.rmtree(producer[1], ignore_errors=True)
            raise
        saver = save_index_async(index, path, cfg)  # the write overlaps the call
        if producer is not None:
            _finish_count_producer(producer, cfg, timer)
    try:
        call(cfg, index, out, timer)
    finally:
        if saver is not None:
            saver.join()
        if producer is not None and producer[2]:
            import shutil

            shutil.rmtree(producer[1], ignore_errors=True)
    timer.pelapsed("Execution completed")
    return 0


def _reusable_index(cfg: Config):
    """The persisted index when its fingerprint matches ``cfg``, else None."""
    path = cfg.index_path()
    if not os.path.exists(path):
        return None
    ok, why = index_matches_config(path, cfg)
    if ok:
        print(f"[{TAG}] reusing index {path}", file=sys.stderr)
        with span("index.load"):
            return load_index(path)
    print(f"[{TAG}] existing index {path} was built with different options ({why}); "
          f"rebuilding", file=sys.stderr)
    return None


def _batch(args, cfg: Config, timer: PhaseTimer) -> int:
    """``batch``: one index, one VCF per read set in ``--out-dir``
    (malva_tpu/cli.py:156-194)."""
    index = _reusable_index(cfg)
    if index is None:
        index = build_index(cfg, timer)
        _try_save_index(index, cfg.index_path(), cfg, timer)
    os.makedirs(args.out_dir, exist_ok=True)
    names: list[str] = []
    seen: dict[str, int] = {}
    for sp in args.sample:
        base = os.path.basename(sp).split(".")[0]
        n = seen.get(base, 0)
        seen[base] = n + 1
        names.append(os.path.join(args.out_dir, f"{base}.{n}.malva.vcf" if n
                                  else f"{base}.malva.vcf"))
    outs = []
    try:
        for name in names:
            outs.append(open(name, "w"))
        call_batch(cfg, index, args.sample, outs, timer)
    finally:
        for f in outs:
            f.close()
    print(f"[{TAG}] wrote: " + " ".join(names), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
