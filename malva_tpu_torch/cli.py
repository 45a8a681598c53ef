"""Command line: ``malva-tpu-torch index | call | run | batch``.

Counterpart of ``malva_tpu/cli.py``, whose parser, config, index
persistence and overlapped counting producer it reuses.  ``--backend``
takes ``auto | host | cuda``.  ``run`` starts the producer (``python -m
malva_tpu.count.spill``, jax-free) only where ``malva_tpu`` would: reads
that route to the card are counted there, inline, after the index phase.
The producer gets a host-backend copy of the config, since
``malva_tpu``'s backend check imports jax for any other backend.
``--profile-dir`` writes a ``torch.profiler`` trace of the command
(CPU, and CUDA on a card) into that directory when it ends.
"""

from __future__ import annotations

import dataclasses
import os
import sys

from malva_tpu.cli import _config, _finish_count_producer, _parser as _base_parser
from malva_tpu.cli import _start_count_producer, _try_save_index
from malva_tpu.pipeline import (
    DEVICE_MIN_READ_BYTES,
    index_matches_config,
    load_index,
    save_index,
    save_index_async,
)
from malva_tpu.utils.config import Config
from malva_tpu.utils.timing import PhaseTimer

from .backend import BACKENDS, resolve
from .pipeline import TAG, _file_size, build_index, call, call_batch


def _parser():
    p = _base_parser(TAG)
    for sub in p._subparsers._group_actions[0].choices.values():
        for action in sub._actions:
            if action.dest == "backend":
                action.choices = BACKENDS
                action.help = "where the device work runs (auto routes by size)"
            if action.dest == "profile_dir":
                action.help = "write a torch.profiler trace into this directory"
    return p


def _overlaps_counting(cfg: Config) -> bool:
    """Whether ``run`` may start the overlapped counting producer: not when
    the reads route to the card, which counts them (malva_tpu/cli.py:277).
    malva_tpu's ``_start_count_producer`` makes its other checks."""
    return resolve(cfg, _file_size(cfg.sample_path), DEVICE_MIN_READ_BYTES) != "cuda"


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

    from malva_tpu.utils.errors import InputError

    try:
        return _main(argv, out if out is not None else sys.stdout)
    except (InputError, OSError, EOFError, struct.error,
            zipfile.BadZipFile, gzip.BadGzipFile, UnicodeDecodeError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


def _main(argv: list[str] | None, out) -> int:
    from malva_tpu.utils.native import tune_malloc

    tune_malloc()
    args = _parser().parse_args(argv)
    cfg = _config(args)
    timer = PhaseTimer(TAG, out=sys.stderr)
    prof = _Profile(args.profile_dir) if args.profile_dir else None
    try:
        return _dispatch(args, cfg, timer, out)
    finally:
        if prof is not None:
            prof.stop()


def _dispatch(args, cfg: Config, timer: PhaseTimer, out) -> int:
    if args.cmd == "index":
        index = build_index(cfg, timer)
        if args.malvax:
            from malva_tpu.io.malvax import write_malvax

            write_malvax(index, cfg.index_path().replace(".malvax.npz", ".malvax.zst"))
        else:
            save_index(index, cfg.index_path(), cfg)
        timer.pelapsed("Index saved")
        return 0

    if args.cmd == "call":
        if args.malvax:
            from malva_tpu.io.malvax import read_malvax
            from malva_tpu.pipeline import Index

            bf, km, ctx = read_malvax(cfg.index_path().replace(".malvax.npz", ".malvax.zst"))
            index = Index(bf=bf, ref_bf=km, context_bf=ctx)
        else:
            path = cfg.index_path()
            if not os.path.exists(path):
                print(f"ERROR: index file {path} not found (run `index` first)", file=sys.stderr)
                return 1
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
            if _overlaps_counting(cfg):
                producer = _start_count_producer(dataclasses.replace(cfg, backend="host"))
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
