"""Command line: ``malva-tpu-torch index | call | run``.

Counterpart of ``malva_tpu/cli.py``, whose parser, config, index
persistence and overlapped counting producer it reuses.  ``--backend``
takes ``auto | host | cuda``.  The producer (``python -m
malva_tpu.count.spill``) is jax-free; it is started with a host-backend
copy of the config, since ``malva_tpu``'s backend check imports jax for
any other backend.  ``batch`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import sys

from malva_tpu.cli import _config, _finish_count_producer, _parser as _base_parser
from malva_tpu.cli import _start_count_producer
from malva_tpu.pipeline import index_matches_config, load_index, save_index, save_index_async
from malva_tpu.utils.timing import PhaseTimer

from .backend import BACKENDS
from .pipeline import TAG, build_index, call


def _parser():
    p = _base_parser(TAG)
    for sub in p._subparsers._group_actions[0].choices.values():
        for action in sub._actions:
            if action.dest == "backend":
                action.choices = BACKENDS
                action.help = "where the device work runs (auto routes by size)"
    return p


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
    if args.cmd == "batch" or args.profile_dir:
        what = "batch" if args.cmd == "batch" else "--profile-dir"
        print(f"ERROR: {what} is not supported by {TAG} yet; use malva-tpu", file=sys.stderr)
        return 2
    cfg = _config(args)
    timer = PhaseTimer(TAG, out=sys.stderr)

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

    # run: reuse a persisted index whose fingerprint matches, else build it
    # with the counting producer overlapped (malva_tpu/cli.py:196-252)
    path = cfg.index_path()
    producer = saver = index = None
    if os.path.exists(path):
        ok, why = index_matches_config(path, cfg)
        if ok:
            print(f"[{TAG}] reusing index {path}", file=sys.stderr)
            index = load_index(path)
        else:
            print(f"[{TAG}] existing index {path} was built with different options "
                  f"({why}); rebuilding", file=sys.stderr)
    if index is None:
        try:
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


if __name__ == "__main__":
    sys.exit(main())
