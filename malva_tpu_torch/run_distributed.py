"""The pipeline in several processes on ``torch.distributed`` (gloo).

Counterpart of ``tools/run_distributed.py``.  One OS process per host:
give every process the same coordinator and world size and its own
process id.  Rank 0 writes the VCF.  It loads no jax.

  python -m malva_tpu_torch.run_distributed --num-processes 2 --process-id 0 \\
      --out out.vcf -1 -b 1 -f AF ref.fa vars.vcf reads0.fq reads1.fq

With ``--spill-dir`` each process counts its reads through the disk
spill, in ``python -m malva_tpu_torch.count.spill`` producers that overlap the
index phase.  ``--timeout`` arms a watchdog over the whole run, and the
process-group set-up has its own (``--timeout``, or 120 s): gloo waits
forever on a lost peer or a mismatched topology, and either watchdog ends
the process with one ``ERROR:`` line.
"""

from __future__ import annotations

import argparse
import io
import os
import subprocess
import sys
import threading

import numpy as np


_spoken = threading.Lock()  # held by whichever prints the run's one ERROR: line


def _error(msg: str) -> None:
    """Print ``ERROR: msg``, unless an ERROR: line is already out."""
    if _spoken.acquire(blocking=False):
        print(f"ERROR: {msg}", file=sys.stderr, flush=True)


def _watchdog(seconds: float, what: str) -> threading.Timer:
    def die():
        _error(f"{what} exceeded {seconds:.0f}s (peer lost mid-collective or process topology "
               f"mismatch); aborting")
        os._exit(1)

    t = threading.Timer(seconds, die)
    t.daemon = True
    t.start()
    return t


def _first_line(e: Exception) -> str:
    return (str(e).strip().splitlines() or [type(e).__name__])[0]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m malva_tpu_torch.run_distributed",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", default="127.0.0.1:19765", help="host:port of rank 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--out", required=True, help="the VCF (written by rank 0)")
    ap.add_argument("--spill-dir", default=None)
    ap.add_argument("--timeout", type=float,
                    default=float(os.environ.get("MALVA_DIST_TIMEOUT", 0)) or None,
                    help="watchdog: abort with a one-line ERROR if the run has not completed "
                         "after this many seconds")
    ap.add_argument("-1", dest="haploid", action="store_true")
    ap.add_argument("-k", type=int, default=35)
    ap.add_argument("-r", type=int, default=43)
    ap.add_argument("-b", type=int, default=1, help="Bloom filter size in GB")
    ap.add_argument("-f", dest="freq_key", default="AF")
    ap.add_argument("reference")
    ap.add_argument("variants")
    ap.add_argument("reads", nargs="+")
    return ap


def main(argv: list[str] | None = None) -> int:
    a = _parser().parse_args(argv)
    # every return cancels both watchdogs, so none can speak after main
    watchdogs = [_watchdog(a.timeout, "distributed run")] if a.timeout else []
    try:
        import torch.distributed as dist

        from .parallel.distributed import (build_index_distributed, call_distributed,
                                           host_shard, initialize, world)
        from .pipeline import build_index
        from .utils.config import Config

        # the topology check is one collective, which can itself hang on a
        # mismatch, so set-up has its own watchdog even without --timeout
        init_timeout = a.timeout or float(os.environ.get("MALVA_INIT_TIMEOUT", 120.0))
        init_watchdog = _watchdog(init_timeout, "distributed init/topology check")
        watchdogs.append(init_watchdog)
        try:
            # gloo's own limit lies past the watchdogs, which speak first
            initialize(a.coordinator, a.num_processes, a.process_id,
                       timeout=(a.timeout or 1800.0) + 60.0)
        except (RuntimeError, ValueError) as e:  # the CLI's one-line ERROR contract
            _error(f"distributed init failed: {_first_line(e)}")
            return 1
        finally:
            init_watchdog.cancel()

        cfg = Config(fasta_path=a.reference, vcf_path=a.variants, sample_path=a.reads[0],
                     k=a.k, ref_k=a.r, error_rate=np.float32(0.001),
                     bf_size=Config.bf_gb_to_bits(a.b), freq_key=a.freq_key,
                     haploid=a.haploid)
        # each process's spill-count producers overlap the index phase;
        # count_distributed resumes their finished stores at the merge
        producers = []
        if a.spill_dir and not os.environ.get("MALVA_NO_OVERLAP"):
            for i, path in enumerate(host_shard(a.reads)):
                producers.append(subprocess.Popen(
                    [sys.executable, "-m", "malva_tpu_torch.count.spill", path, str(a.r),
                     f"{a.spill_dir}/h{a.process_id}_{i}"], stdout=subprocess.DEVNULL))
        try:
            index = build_index_distributed(cfg) if a.num_processes > 1 else build_index(cfg)
            for p in producers:
                if p.wait() != 0:
                    print("[malva-tpu-torch/dist] overlapped counting producer failed; "
                          "counting resumes inline", file=sys.stderr)
            out = open(a.out, "w") if world()[0] == 0 else io.StringIO()
            with out:
                call_distributed(cfg, index, a.reads, out, spill_dir=a.spill_dir)
        except dist.DistError as e:  # a lost peer that gloo reports instead of hanging
            _error(f"distributed run failed: {_first_line(e)}")
            return 1
        finally:
            for p in producers:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
        return 0
    finally:
        for w in watchdogs:
            w.cancel()


if __name__ == "__main__":
    sys.exit(main())
