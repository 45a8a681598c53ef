"""The default multi-card ``run`` against the one-card ``run`` on one host.

On a host with several cards ``run --backend cuda`` shards its index over
all of them without being asked (``backend.mesh_for``); under
``CUDA_VISIBLE_DEVICES=0`` it runs on one card.  This tool makes
chip_smoke.py's chr-scale inputs (``tools/make_synth_scale.py --mbp 10
--variants 100000 --samples 50 --coverage 5 --seed 7``) and runs ``run
--backend cuda -k 35 -r 43 -b 1 -f AF`` from each given checkout, each run
in its own process on its own copy of the inputs: with every card visible
and with one, in turns (checkout A all cards, A one card, B all cards, B
one card, then the next round in the reverse order), three rounds, or
``--rounds N``.  On a host of three cards or more each round also runs
every checkout on the first two cards (between all and one).
Every VCF must be byte-identical to the first.  Each checkout builds its
kernels and native library in a process of its own first, so no run
includes a build.

After the runs, in this process, the host-to-card probe behind the
sharded path's ``upload`` and ``replicate``: 1 GiB of uint32 from pageable
host memory whole to every card against whole to the first card and
copied card to card to the others, and a slice to each card one after
another against from one thread per card.

Prints one line per run and one JSON object as the last line: the card,
the probe, every run (wall, PhaseTimer phases, the sharded path's metrics
lines, and the process's exit: from the CLI's "main returned" line to the
process's end, where the checkout logs one) and, per checkout and card
count, the median wall, exit and phases.

    python -m malva_tpu_torch.tools.multicard_run              # this checkout
    python -m malva_tpu_torch.tools.multicard_run OLD NEW      # two checkouts
    python -m malva_tpu_torch.tools.multicard_run --rounds 5 OLD NEW

It needs a checkout (``tools/make_synth_scale.py``) and at least two cards.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
SYNTH = ["--mbp", "10", "--variants", "100000", "--samples", "50", "--coverage", "5",
         "--seed", "7"]
RUN = ["run", "--backend", "cuda", "-k", "35", "-r", "43", "-b", "1", "-f", "AF"]
INPUTS = ("synth.fa", "synth.vcf", "synth.fq")
GIB_WORDS = 1 << 28  # 1 GiB of uint32
ROUNDS = 3


def log(msg: str) -> None:
    print(f"[multicard] {msg}", file=sys.stderr, flush=True)


def phase_walls(stderr: str) -> dict:
    """PhaseTimer walls by phase; the index pass's progress heartbeats
    ("Processed N variants") are summed into one entry."""
    walls: dict[str, float] = {}
    for m in re.finditer(r"\[malva-tpu-torch/([^\]]+)\] Execution Time ([0-9.e+-]+)s", stderr):
        name = re.sub(r"^Processed \d+ variants$", "Processed variants (heartbeats)", m.group(1))
        name = re.sub(r"^Counters ready: .*/", "Counters ready: ", name)
        walls[name] = round(walls.get(name, 0.0) + float(m.group(2)), 6)
    return walls


def metric_lines(stderr: str) -> list[str]:
    """The lines the sharded path and the call step log about themselves."""
    return [ln for ln in stderr.splitlines()
            if ln.startswith("[malva-tpu-torch/metrics]") or ln.startswith("[malva-tpu-torch] "
                                                                          "sharded")]


def make_inputs(out_dir: str) -> None:
    subprocess.run([sys.executable, str(REPO / "tools" / "make_synth_scale.py"), out_dir, *SYNTH],
                   check=True)


def prepare(checkout: str) -> None:
    """Build the checkout's kernels and native host library, in a process
    of its own, so that no timed run includes a build."""
    subprocess.run([sys.executable, "-c", "from malva_tpu_torch.ops import _build; "
                    "from malva_tpu_torch.utils import native; _build.library(); native.load()"],
                   cwd=checkout, env=dict(os.environ, PYTHONPATH=checkout), check=True)


def run_once(checkout: str, src: str, work: str, visible: str | None, label: str) -> dict:
    """``run`` from ``checkout`` on a private copy of the inputs in
    ``src``, with ``CUDA_VISIBLE_DEVICES`` set to ``visible`` (unset where
    None: every card of the host); its VCF path, process wall, phases and
    metrics lines, under ``label``."""
    os.makedirs(work)
    fa, vcf, fq = (shutil.copy(os.path.join(src, n), os.path.join(work, n)) for n in INPUTS)
    env = dict(os.environ, PYTHONPATH=checkout, MALVA_SPILL_SHM="0")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    if visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = visible
    out = os.path.join(work, "out.vcf")
    t0 = time.perf_counter()
    with open(out, "w") as f:
        p = subprocess.run([sys.executable, "-m", "malva_tpu_torch.cli", *RUN, fa, vcf, fq],
                           cwd=checkout, env=env, stdout=f, stderr=subprocess.PIPE, text=True)
    wall, ended = time.perf_counter() - t0, time.time()
    returned = re.search(r"main returned at ([0-9.]+) s", p.stderr)
    if p.returncode != 0:
        raise RuntimeError(f"run in {checkout} ({label} cards) exited {p.returncode}: "
                           f"{p.stderr[-3000:]}")
    return {"checkout": checkout, "cards": label, "vcf": out, "wall_s": wall,
            "exit_s": ended - float(returned.group(1)) if returned else None,
            "phases": phase_walls(p.stderr), "metrics": metric_lines(p.stderr)}


def probe() -> dict:
    """1 GiB from pageable host memory to the cards, in seconds, each way
    ending in a synchronize of every card (each card started, and one
    slice copied to the first, untimed, first)."""
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    whole = torch.from_numpy(np.arange(GIB_WORDS, dtype=np.uint32).view(np.int32))
    cut = GIB_WORDS // len(cards)
    parts = [whole[i * cut : (i + 1) * cut] for i in range(len(cards))]
    for d in cards:
        torch.zeros(1, device=d)
    parts[0].to(cards[0])

    def whole_then_peer():
        first = whole.to(cards[0])
        return [first] + [first.to(d, non_blocking=True) for d in cards[1:]]

    def slices_threads():
        with ThreadPoolExecutor(len(cards)) as pool:
            return list(pool.map(lambda p, d: p.to(d), parts, cards))

    out: dict = {"cards": len(cards)}
    for name, fn in (("whole_to_each_s", lambda: [whole.to(d) for d in cards]),
                     ("whole_to_first_then_peer_s", whole_then_peer),
                     ("slices_serial_s", lambda: [p.to(d) for p, d in zip(parts, cards)]),
                     ("slices_threads_s", slices_threads)):
        t0 = time.perf_counter()
        got = fn()
        for d in cards:
            torch.cuda.synchronize(d)
        out[name] = time.perf_counter() - t0
        del got
        torch.cuda.empty_cache()
    return out


def medians(runs: list[dict]) -> dict:
    """Per checkout and card count: the median process wall and the median
    of each phase over the runs."""
    out: dict = {}
    for r in runs:
        e = out.setdefault(r["checkout"], {}).setdefault(r["cards"],
                                                          {"walls": [], "exits": [], "phases": {}})
        e["walls"].append(r["wall_s"])
        if r.get("exit_s") is not None:
            e["exits"].append(r["exit_s"])
        for name, v in r["phases"].items():
            e["phases"].setdefault(name, []).append(v)
    return {c: {k: {"wall_s": statistics.median(e["walls"]), "walls_s": e["walls"],
                    "exit_s": statistics.median(e["exits"]) if e["exits"] else None,
                    "exits_s": e["exits"],
                    "phases": {n: statistics.median(v) for n, v in e["phases"].items()}}
                for k, e in by.items()} for c, by in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="*", help="checkouts to run from (default: this one)")
    ap.add_argument("--rounds", type=int, default=ROUNDS,
                    help=f"rounds of alternated runs (default {ROUNDS})")
    args = ap.parse_args(argv)
    if args.rounds < 1:
        raise SystemExit("multicard_run: --rounds takes 1 or more")
    if torch.cuda.device_count() < 2:  # counts the cards, makes no context
        raise SystemExit("multicard_run: needs at least two cards")
    checkouts = [os.path.abspath(c) for c in args.checkouts or [str(REPO)]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    tmp = tempfile.mkdtemp(prefix="malva_multicard_")
    try:
        src = os.path.join(tmp, "in")
        make_inputs(src)
        for c in checkouts:
            prepare(c)
        runs, first = [], None
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        ids = (visible or ",".join(map(str, range(torch.cuda.device_count())))).split(",")
        legs = ([(visible, "all")] + ([(",".join(ids[:2]), "two")] if len(ids) >= 3 else [])
                + [(ids[0], "one")])
        for r in range(args.rounds):
            for c in (checkouts if r % 2 == 0 else checkouts[::-1]):
                for vis, label in legs:
                    got = run_once(c, src, os.path.join(tmp, f"r{len(runs)}"), vis, label)
                    vcf = open(got.pop("vcf"), "rb").read()
                    if first is None:
                        first = vcf
                    elif vcf != first:
                        raise AssertionError(f"run {len(runs)} ({c}, {got['cards']} cards): the "
                                             f"VCF differs from the first run's")
                    got["round"] = r
                    runs.append(got)
                    log(f"{c} {got['cards']} card(s), round {r}: {got['wall_s']:.6g} s "
                        f"(exit {got['exit_s']}); "
                        f"{json.dumps(got['phases'])}; " + " | ".join(got["metrics"]))
        probed = probe()
        log(f"probe: {json.dumps(probed)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"cards": smi, "count": torch.cuda.device_count(), "vcfs_identical": True,
                      "probe": probed, "medians": medians(runs), "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
