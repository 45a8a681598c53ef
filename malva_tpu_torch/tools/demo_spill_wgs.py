"""Bounded-memory k-mer counting at WGS scale, on the card or on the host.

Counterpart of ``tools/demo_spill_wgs.py``: the same arguments, defaults,
checksum and two ``[spill-demo]`` lines, through the port's
``count/spill.py count_reads_kmers_spill``.  The sort-count runs where
``--device`` says:

- ``cuda`` (default): on the card, K3 and the sort-count of each piece
  of the spill's ``chunk_kmers`` windows (``counter.iter_device_runs``);
  without a card the tool exits non-zero and counts nothing;
- ``host``: the native host library (the JAX tool's ``use_device=False``);
- ``cpu``: the device route on torch's CPU with the plain K3, for the
  tests; its times are the CPU's.

A last JSON line gives the kept distinct k-mers, their total and the
checksum (XOR over the merged stream of each word times
0x9E3779B97F4A7C15, then the count: the JAX tool's, so the two compare on
the same reads), the input and spill sizes, the wall (torch's import
where the route takes torch, the card's context and the kernels on a
card, and the native host library's build or load come before it, in
``setup_s``), the peak RSS at the end, after the set-up
(``peak_rss_setup_gb``) and when the counting is done, before the merge
(``peak_rss_count_gb``), and after each step of the set-up
(``rss_setup_split_gb``: ``import_torch``, ``context``, ``kernels`` on
the routes that take them, then ``host_library``), the peak device
memory on a card (``torch.cuda.max_memory_allocated``), and ``split_s``,
where the wall went.  Peak RSS is ``VmHWM``, which starts anew at exec,
where the kernel gives it, else ``ru_maxrss`` (``peak_rss_from``;
``utils/timing.py peak_rss_gb``): start the tool from a shell, as
``ru_maxrss`` keeps the peak of a parent that exec'd into it.  The
``host`` route imports no torch.  The split:

- every route: ``host_read_s`` (reading and parsing the reads),
  ``spill_write_s`` (``SpillStore.add_segment``), ``merge_s``
  (``SpillStore.iter_merged``), ``checksum_s`` and ``unattributed_s``,
  the rest of the wall;
- ``host``: ``host_count_s``, the native chunk sort-count;
- ``cuda`` and ``cpu``: ``chunk_assembly_s`` (the host's joins of reads
  into pieces) and, summed over the pieces, ``upload_s``,
  ``k3_seq_pack_s``, ``sort_count_s`` and ``read_back_s``, cut by CUDA
  events recorded in the step (``count/stats.py CountStats``); a piece's
  host time outside its events is left unattributed.

Make the reads with ``tools/make_reads.py`` (100 Mbp x 30 is the 3-Gbase
row of BASELINE.md), then::

    python tools/make_reads.py reads.fq --genome-mbp 100 --coverage 30 --error 0.01 --seed 0
    python -m malva_tpu_torch.tools.demo_spill_wgs reads.fq
    python -m malva_tpu_torch.tools.demo_spill_wgs reads.fq --device host
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

MIX = np.uint64(0x9E3779B97F4A7C15)
# the device pieces' parts (CountStats marks) and their keys in split_s
CARD_PARTS = {"upload": "upload_s", "seq_pack": "k3_seq_pack_s", "sort_count": "sort_count_s",
              "read_back": "read_back_s"}


def checksum(keys: np.ndarray, cnts: np.ndarray) -> np.uint64:
    """The JAX tool's checksum of one merged batch of (keys, counts)."""
    with np.errstate(over="ignore"):
        h = np.zeros(keys.shape[0], dtype=np.uint64)
        for j in range(keys.shape[1]):
            h ^= keys[:, j] * MIX
        h ^= cnts.astype(np.uint64)
    return np.bitwise_xor.reduce(h) if h.size else np.uint64(0)


def split_of(stats, wall_s: float, device) -> dict:
    """The wall in parts (see the module's docstring); the parts are
    disjoint intervals of the wall, so they sum to at most ``wall_s``."""
    s = stats.seconds
    produce, read = s.get("produce", 0.0), s.get("read", 0.0)
    split = {"host_read_s": read}
    if device is None:
        split["host_count_s"] = produce - read
    else:
        split["chunk_assembly_s"] = produce - read - s.get("pieces", 0.0)
        split.update({key: s.get(part, 0.0) for part, key in CARD_PARTS.items()})
    split.update(spill_write_s=s.get("spill_write", 0.0), merge_s=s.get("merge", 0.0),
                 checksum_s=s.get("checksum", 0.0))
    split["unattributed_s"] = wall_s - sum(split.values())
    return split


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("reads")
    ap.add_argument("--ref-k", type=int, default=43)
    ap.add_argument("--spill", default=os.path.join(tempfile.gettempdir(), "malva_spill_demo"))
    ap.add_argument("--ci", type=int, default=2)
    ap.add_argument("--cs", type=int, default=255)
    ap.add_argument("--device", default="cuda", choices=("cuda", "host", "cpu"),
                    help="where the sort-count runs: cuda (default), host (native library) "
                         "or cpu (the plain K3 on torch's CPU, for the tests)")
    args = ap.parse_args(argv)
    from ..count.spill import count_reads_kmers_spill
    from ..count.stats import CountStats
    from ..utils import native
    from ..utils.timing import peak_rss_from, peak_rss_gb

    # before the wall, each with the peak RSS after it: torch's import and,
    # on a card, its context and the kernels; the host library (built at
    # first use)
    t0 = time.perf_counter()
    split_gb = {}
    device = kernels = None
    if args.device != "host":
        import torch

        split_gb["import_torch"] = peak_rss_gb()
        device = torch.device(args.device)
        from ..ops import _build, kernels

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("demo_spill_wgs: no CUDA device; --device host counts on the host")
        device = torch.device("cuda", 0)
        torch.zeros(1, device=device)
        split_gb["context"] = peak_rss_gb()
        _build.library()
        split_gb["kernels"] = peak_rss_gb()
    threads = native.threads()
    split_gb["host_library"] = rss_setup_gb = peak_rss_gb()
    setup_s = time.perf_counter() - t0

    if kernels is not None:
        kernels.reset_launches()
    stats = CountStats()
    t0 = time.perf_counter()
    distinct = total = 0
    chk = np.uint64(0)
    merged = count_reads_kmers_spill(args.reads, args.ref_k, args.spill, ci=args.ci, cs=args.cs,
                                     device=device, stats=stats)
    rss_count_gb = peak_rss_gb()
    for keys, cnts in merged:
        distinct += keys.shape[0]
        total += int(cnts.sum())
        with stats.timed("checksum"):
            chk ^= checksum(keys, cnts)
    wall = time.perf_counter() - t0
    rss_gb = peak_rss_gb()
    print(f"[spill-demo] kept_distinct={distinct} kept_total={total} checksum={int(chk):016x}")
    print(f"[spill-demo] wall={wall:.0f}s peak_rss={rss_gb:.2f}GB")
    result = {"kept_distinct": distinct, "kept_total": total, "checksum": f"{int(chk):016x}",
              "reads_bytes": os.path.getsize(args.reads), "windows": stats.windows,
              "segments": stats.segments, "pieces": stats.pieces,
              "seq_pack_launches": 0 if kernels is None else kernels.LAUNCHES["seq_pack"],
              "spill_bytes": stats.spill_bytes, "wall_s": wall, "setup_s": setup_s,
              "peak_rss_gb": rss_gb, "peak_rss_setup_gb": rss_setup_gb,
              "peak_rss_count_gb": rss_count_gb, "rss_setup_split_gb": split_gb,
              "peak_rss_from": peak_rss_from()}
    if args.device == "cuda":
        result["peak_device_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    result.update(device=(torch.cuda.get_device_name(device) if args.device == "cuda"
                          else args.device),
                  ref_k=args.ref_k, cpu_cores=os.cpu_count(), native_threads=threads,
                  split_s=split_of(stats, wall, device))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
