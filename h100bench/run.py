"""The benchmark of malva_tpu_torch on one card: genotype one sample after
another against a persisted index, as a lab's pipeline does.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``workloads/<cell>.json``) names a configuration
(``configs/<name>.json``), the job and its traffic.  Set-up makes the
inputs from the seed under ``$TMPDIR`` (a genome slice, a gzipped cohort
VCF, a pool of donors' reads), builds the kernels where they are not
built yet, runs the program's ``index`` once on the card, which saves the
index beside the VCF, and one warm-up sample.  The window then runs
``call --backend cuda`` in this process on one donor after another, in a
closed loop, until ``--seconds`` have passed, and finishes the sample in
flight.  After it, the plain reference (``reference/``) judges the index
file and a seeded draw of the window's VCFs (``check.py``).

The last line of stdout is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones, each read by ``metrics/<name>.py``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also end stderr.  Without a card,
or where the process holds jax, jaxlib, flax or malva_tpu once the
window has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "h100bench")
FORBIDDEN = ("jax", "jaxlib", "flax", "malva_tpu")
BACKEND = "cuda"  # the program's --backend in every run; the tests take the host's
CACHES = {"CUDA_CACHE_PATH": "cuda", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}


def log(msg: str) -> None:
    print(f"[h100bench] {msg}", file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (``/proc``, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str) -> tuple[dict, dict, dict]:
    """(benchmark, workload, configuration) of a cell, found by name."""
    bench = load_json(ROOT, "BENCHMARK.json")
    if name not in {w["name"] for w in bench["workloads"]}:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    workload = load_json(HERE, "workloads", f"{name}.json")
    return bench, workload, load_json(HERE, "configs", f"{workload['config']}.json")


def metric_units(bench: dict, cell: str, trace: bool) -> dict:
    """{name: unit} of the metrics a run of ``cell`` reports: its
    end-to-end ones, or with a trace the per-layer ones read in it."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if trace:
        moved = {m["name"] for m in e2e}
        e2e = [m for m in bench["per_layer"]
               if cell in m.get("workloads", [cell]) and m["moves"] in moved]
    return {m["name"]: m["unit"] for m in e2e}


def genotyper_flags(flags: list) -> argparse.Namespace:
    """The values the reference needs from the configuration's flags,
    with the genotyper's defaults."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("-k", type=int, default=35)
    p.add_argument("-r", type=int, default=43)
    p.add_argument("-b", type=int, default=4)
    p.add_argument("-c", type=int, default=200)
    p.add_argument("-e", type=float, default=0.001)
    p.add_argument("-f", default="AF")
    p.add_argument("-1", dest="haploid", action="store_true")
    p.add_argument("-v", dest="verbose", action="store_true")
    return p.parse_args(flags)


class Tee(io.TextIOBase):
    """stderr that keeps each write with the time it was made."""

    def __init__(self, real):
        self.real, self.lines = real, []

    def write(self, s):
        self.lines.append([time.monotonic(), s])
        return self.real.write(s)

    def flush(self):
        self.real.flush()


def cli(argv: list, out_path: str | None) -> dict:
    """One command of the program in this process: its exit code, its
    stderr with times, and its start and end."""
    from malva_tpu_torch import cli as program

    tee = Tee(sys.stderr)
    t0 = time.monotonic()
    rc = None
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(out_path, "w")) if out_path else None
        stack.enter_context(contextlib.redirect_stderr(tee))
        try:
            rc = program.main(argv, out=out)
        except Exception:  # a sample that raises is a failed sample, not the end of the run
            traceback.print_exc()
            rc = -1
    return {"rc": rc, "lines": tee.lines, "t0": t0, "t1": time.monotonic()}


def make_inputs(workload: dict, config: dict, seed: int, work: str):
    from h100bench.gen.cohort import make_cohort, rng_for
    from h100bench.gen.reads import make_donor, pick_donors

    cohort = make_cohort(config, seed, work)
    donors = pick_donors(cohort, int(workload["donors"]), rng_for(seed, 1))
    reads = [make_donor(cohort, cols, workload, rng_for(seed, 100 + i),
                        os.path.join(work, f"donor{i}.fq.gz"))
             for i, cols in enumerate(donors)]
    return cohort, reads


def build_program() -> None:
    """Build what the program compiles at first use (its kernels with
    nvcc, its host library with g++), where a run before has not."""
    from malva_tpu_torch.ops import _build
    from malva_tpu_torch.utils import native

    _build.library()
    if native.load() is None:
        raise RuntimeError("the native host library did not build")


def trace_events(prof, path: str, marker_t: float) -> list:
    """[name, kind, start, seconds] of the device's activity, on the
    host's monotonic clock (aligned by the window's annotation)."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    os.unlink(path)
    marks = [e for e in events if e.get("name") == "h100bench.window"
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the trace holds no window annotation")
    offset = marks[0]["ts"] / 1e6 - marker_t
    return [[e["name"], e["cat"], e["ts"] / 1e6 - offset, e["dur"] / 1e6]
            for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def window(argv_of, readsets: list, work: str, seconds: float, profile) -> tuple:
    """Samples one after another until ``seconds`` have passed; the one
    in flight is finished.  -> (record's window and samples, attempted,
    failed, VCF path of each completed sample, device events)."""
    samples, vcfs, failed, i = [], [], 0, 0
    ctx = profile() if profile else contextlib.nullcontext()
    with ctx as prof:
        mark = contextlib.nullcontext()
        if prof is not None:
            from torch.profiler import record_function

            mark = record_function("h100bench.window")
        with mark:
            t0 = time.monotonic()
            while True:
                rs = readsets[i % len(readsets)]
                out = os.path.join(work, f"sample{i}.vcf")
                s = cli(argv_of(rs.path), out)
                s["donor"] = i % len(readsets)
                i += 1
                if s["rc"] == 0:
                    samples.append(s)
                    vcfs.append(out)
                else:
                    failed += 1
                if time.monotonic() - t0 >= seconds:
                    break
            t1 = time.monotonic()
    events = trace_events(prof, os.path.join(work, "trace.json"), t0) if prof else None
    return (t0, t1), samples, i, failed, vcfs, events


def judge(cohort, readsets: list, samples: list, vcfs: list, index_path: str,
          flags: argparse.Namespace, n_check: int, seed: int) -> dict:
    """The numbers compared: the index file, and the VCFs of a seeded draw
    of the window's samples, one a donor at most."""
    from h100bench import check
    from h100bench.gen.cohort import rng_for
    from h100bench.reference.malva import Reference

    t = time.monotonic()
    ref = Reference.build(cohort, flags.b << 33, flags.k, flags.r, flags.haploid,
                          flags.verbose, flags.c, flags.e)
    out = {"index_diff": check.index_diff(index_path, ref.index)}
    rng = rng_for(seed, 2)
    chosen, donors = [], set()
    for i in rng.permutation(len(samples)).tolist():
        if samples[i]["donor"] not in donors and len(chosen) < n_check:
            chosen.append(i)
            donors.add(samples[i]["donor"])
    diff = 0 if chosen else 1
    for i in chosen:
        state = ref.state(readsets[samples[i]["donor"]].reads)
        diff += check.vcf_diff(check.vcf_records(vcfs[i]), ref.vcf(state))
    out["vcf_diff"] = diff
    log(f"reference: {time.monotonic() - t:.6g} s for the index and {len(chosen)} of "
        f"{len(samples)} samples (window samples {chosen})")
    return out


def card(chips: int) -> dict | None:
    """The card's name, count and power limit, or None without enough."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return None
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit"] = smi.stdout.splitlines()[0].strip() if smi.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired, IndexError):
        info["power_limit"] = None
    return info


def memory_peak_bytes() -> int:
    import torch

    return int(torch.cuda.max_memory_allocated()) if torch.cuda.is_available() else 0


def profiler():
    """The profiler of a traced window: the card's kernels and copies, and
    the host's annotations that align them."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def run_cell(workload: dict, config: dict, seed: int, seconds: float, trace: bool,
             units: dict, backend: str = "cuda", device: dict | None = None) -> dict:
    """One run of a cell; the result's dict (the last line's keys)."""
    from h100bench.gen.reads import k3_windows

    flags = genotyper_flags(config["flags"])
    work = tempfile.mkdtemp(prefix="h100bench-", dir=os.environ.get("TMPDIR"))
    try:
        setup = {"imports": process_age_s()}
        t = time.monotonic()
        cohort, readsets = make_inputs(workload, config, seed, work)
        setup["inputs"] = time.monotonic() - t
        t = time.monotonic()
        if backend == "cuda":
            build_program()
        setup["build"] = time.monotonic() - t
        base = [workload["job"], "--backend", backend, *config["flags"]]
        s = cli(["index", "--backend", backend, *config["flags"], cohort.fasta, cohort.vcf,
                 readsets[0].path], None)
        setup["index"] = s["t1"] - s["t0"]
        if s["rc"] != 0:
            raise RuntimeError(f"index exited {s['rc']}")
        s = cli(base + [cohort.fasta, cohort.vcf, readsets[0].path],
                os.path.join(work, "warmup.vcf"))
        setup["warm-up"] = s["t1"] - s["t0"]
        if s["rc"] != 0:
            raise RuntimeError(f"the warm-up sample exited {s['rc']}")
        setup_s = process_age_s()
        log("set-up " + ", ".join(f"{k} {v:.6g} s" for k, v in setup.items())
            + f"; {setup_s:.6g} s in all")

        (t0, t1), samples, attempted, failed, vcfs, events = window(
            lambda reads: base + [cohort.fasta, cohort.vcf, reads], readsets, work, seconds,
            profiler if trace else None)
        dev = dict(device or {"platform": "cpu", "kind": "cpu", "count": 1})
        dev["memory_peak_bytes"] = memory_peak_bytes()
        gc.collect()
        record = {"window": (t0, t1), "setup_s": setup_s, "k": flags.k, "device": events,
                  "samples": [{"t0": s["t0"], "t1": s["t1"], "lines": s["lines"],
                               "k3_windows": k3_windows(readsets[s["donor"]].reads, flags.r),
                               "ref_k": flags.r} for s in samples]}
        metrics = {}
        for name, unit in units.items():
            value = importlib.import_module(f"h100bench.metrics.{name}").read(record)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
        result = {"attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
        if trace:
            from h100bench import record as rec

            dev["busy_s"] = rec.busy_s(record)
            dev["window_s"] = t1 - t0
            result["breakdown"] = {"device_ops": [[n[:120], t] for n, t in
                                                  rec.device_ops(record)[:10]],
                                   "idle_gaps": rec.idle_gaps(record)[:10]}
        log(f"window: {len(samples)} samples in {t1 - t0:.6g} s, {failed} failed")
        checks = judge(cohort, readsets, samples, vcfs, cohort.vcf + f".c{flags.r}.k{flags.k}"
                       ".malvax.npz", flags, int(workload["checked_samples"]), seed)
        from h100bench.check import LIMITS

        result["correct"] = failed == 0 and all(checks[n] <= LIMITS[n] for n in LIMITS)
        result["checks"] = {n: {"value": checks[n], "limit": LIMITS[n]} for n in LIMITS}
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def program_in_checkout() -> bool:
    """Whether the program under test is this checkout's own copy (and not
    missing, or one installed elsewhere)."""
    import importlib.util

    spec = importlib.util.find_spec("malva_tpu_torch")
    return spec is not None and spec.origin is not None and \
        os.path.abspath(spec.origin).startswith(os.path.join(ROOT, "malva_tpu_torch") + os.sep)


def forbidden_modules() -> list:
    """Modules whose top-level name (before the first dot) is forbidden."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", "h100bench", sub)
    bench, workload, config = load_cell(args.workload)
    if not program_in_checkout():
        log(f"malva_tpu_torch is not in this checkout ({ROOT}): nothing measured")
        return 4
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    device = card(chips)
    if device is None:
        log(f"no CUDA card, or fewer than the {chips} the cell asks for: nothing measured")
        return 2
    result = run_cell(workload, config, args.seed, args.seconds, bool(args.trace),
                      metric_units(bench, args.workload, bool(args.trace)), BACKEND, device)
    bad = forbidden_modules()
    if bad:
        log(f"the process holds {', '.join(bad)}: no result")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    order = ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    print(json.dumps({k: result[k] for k in order if k in result}), flush=True)
    return 0


if __name__ == "__main__":
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    sys.exit(main())
