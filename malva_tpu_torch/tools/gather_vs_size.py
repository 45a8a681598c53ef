"""The call step's one mandatory random access against the table's size.

Counterpart of ``tools/gather_vs_size.py``: B = 2^21 random rows gathered
from a table of 1 MiB to 2 GiB, as 8-byte rows (``row8``: the JAX tool's
(B, 2) 32-bit row gather, a Bloom row) and as 4-byte words (``word4``: the
size of the random reads K7 and K4's slot entry make, from the same bytes).
On an H100 the curve says where a table leaves the 50 MB L2: 2^22 rows (32
MiB) is measured beside the JAX tool's sizes for a point on each side.

Each size's table and indices come from a ``torch.Generator`` seeded with
the size.  The gather is ``torch.index_select`` (the JAX tool's
``jnp.take``); each gathered batch is summed into an accumulator so that
no gather can be skipped; both routes sum the batch as int64 words.
``ms_per_batch`` is one gather and its sum, CUDA events over ``ITERS`` of
them after a warm-up, queued behind a spin of the card so that the host's
launches do not set the time; it includes the index read, the batch's
write and its sum, the same at every size, and ``sum_ms_per_batch`` is
the sum alone.  One JSON line per size and route: the table's ``bytes``,
``ms_per_batch``, ``M_rows_per_s``, ``sum_ms_per_batch`` and ``sum`` (the
accumulator).

    python -m malva_tpu_torch.tools.gather_vs_size
    python -m malva_tpu_torch.tools.gather_vs_size --device cpu --max-log2-rows 12

On the CPU the times are the CPU's, by the host clock.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

BATCH = 1 << 21
ITERS = 8
LOG2_ROWS = (17, 19, 21, 22, 23, 25, 27, 28)  # 8-byte rows: 1 MiB ... 2 GiB
ROUTES = {"row8": torch.int64, "word4": torch.int32}
SPIN_CYCLES = 4_000_000  # torch.cuda._sleep: at least 2 ms at 2 GHz


def inputs(log2_rows: int, route: str, device: torch.device):
    """The table of 2^log2_rows 8-byte rows' bytes, as ``route``'s
    elements, and ITERS + 1 rows of BATCH int32 indices into it (the
    first for the warm-up)."""
    g = torch.Generator(device=device).manual_seed(log2_rows)
    words = torch.randint(-(1 << 31), 1 << 31, (2 << log2_rows,), dtype=torch.int32,
                          generator=g, device=device)
    table = words.view(ROUTES[route])
    idx = torch.randint(0, table.numel(), (ITERS + 1, BATCH), dtype=torch.int32, generator=g,
                        device=device)
    return table, idx


def card_ms(fn, n: int, device: torch.device) -> float:
    """ms a call of ``fn(i)`` for i < n: CUDA events around calls queued
    behind a spin of the card, so that the host's launches do not set the
    time; the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        return (time.perf_counter() - t0) * 1e3 / n
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(device)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(n):
        fn(i)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def time_gathers(table: torch.Tensor, idx: torch.Tensor) -> tuple[float, float, int]:
    """ms a gather and its sum over idx[1:]; ms of the sum alone, over a
    batch gathered before; and the sum of every batch gathered over
    idx[1:], read as int64 words (wrapping)."""
    def gather(rows: torch.Tensor) -> torch.Tensor:
        return table.index_select(0, rows).view(torch.int64)

    acc = torch.zeros((), dtype=torch.int64, device=table.device)
    batch = gather(idx[0])
    acc.add_(batch.sum())  # warm-up: every kernel of the timed loops loaded
    acc.zero_()
    ms = card_ms(lambda i: acc.add_(gather(idx[i + 1]).sum()), ITERS, table.device)
    total = int(acc)
    sum_ms = card_ms(lambda i: acc.add_(batch.sum()), ITERS, table.device)
    return ms, sum_ms, total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--max-log2-rows", type=int, default=max(LOG2_ROWS),
                    help="cap on the table's 8-byte rows, log2: larger sizes are cut to it")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("gather_vs_size: no CUDA device (pass --device cpu for the CPU)")
        device = torch.device("cuda", 0)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[gvs] {where}; batch {BATCH}, {ITERS} timed gathers a size", file=sys.stderr)
    for log2_rows in sorted({min(n, args.max_log2_rows) for n in LOG2_ROWS}):
        for route in ROUTES:
            table, idx = inputs(log2_rows, route, device)
            ms, sum_ms, total = time_gathers(table, idx)
            n_bytes = table.numel() * table.element_size()
            print(f"[gvs] {route} table {n_bytes / (1 << 20):8.1f} MiB  {ms:8.4f} ms/batch  "
                  f"({BATCH / ms / 1e3:8.1f} M rows/s; the sum alone {sum_ms:.4f} ms)",
                  file=sys.stderr)
            print(json.dumps({"route": route, "row_bytes": table.element_size(),
                              "rows": table.numel(), "bytes": n_bytes, "batch": BATCH,
                              "ms_per_batch": ms, "M_rows_per_s": BATCH / ms / 1e3,
                              "sum_ms_per_batch": sum_ms, "sum": total, "device": where}),
                  flush=True)
            del table, idx
    return 0


if __name__ == "__main__":
    sys.exit(main())
