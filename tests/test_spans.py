"""The port's span-and-counter recorder (``utils/timing.py``) and the spans
it records inside ``call``.

The recorder's units (nesting, a second thread, counters, a span closed
by an exception, GC, the line), then ``call`` on the diploid data: the
host route's spans and counters against its phases and golden VCF, the
device route on CPU tensors (the upload's parts and bytes), the
``--profile-dir`` ranges, and the stderr lines the benchmark parses,
which must read as before.  Last, the native extraction's block counters
(``<pass>.extract_blocks``, ``_units``, ``_busy_us``, ``_critical_us``)
on the benchmark generator's two deployments cut small: the
SARS-CoV-2 panel, whose records chain into one block, and the
1000 Genomes-shaped cohort, whose records fall into many.
"""

import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from malva_tpu_torch import cli
from malva_tpu_torch import pipeline as tp
from malva_tpu_torch.utils import timing
from malva_tpu_torch.utils.config import Config
from malva_tpu_torch.utils.timing import PhaseTimer, add_span, carried, count, span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from h100bench import record as bench_record  # noqa: E402  (the benchmark's stderr patterns)

D = os.path.join(REPO, "tests", "data", "diploid")
GOLDEN = os.path.join(D, "golden.vcf")
SPANS = "[malva-tpu-torch/spans] "

PASS2 = {"pass2.scan", "pass2.gt_parse", "pass2.extract", "pass2.held", "pass2.put_wait",
         "pass2.wait", "pass2.coverage", "pass2.genotype", "pass2.format"}
CONSUMER = {"pass2.wait", "pass2.coverage", "pass2.genotype", "pass2.format"}
COUNT = {"count.read", "count.piece", "count.merge"}


def _timer():
    return PhaseTimer("malva-tpu-torch", out=io.StringIO())


def _rows(timer):
    return [dict(zip(timing.SPAN_FIELDS, row)) for row in timer.spans]


def _by_name(rows, name):
    hits = [r for r in rows if r["name"] == name]
    assert len(hits) == 1, (name, hits)
    return hits[0]


def test_nesting_and_parents():
    timer = _timer()
    with timer.recording():
        with span("outer"):
            with span("inner"):
                pass
        timer.pelapsed("First phase")
        with span("later"):
            pass
    rows = _rows(timer)
    outer, inner, later = (_by_name(rows, n) for n in ("outer", "inner", "later"))
    phase = _by_name(rows, "First phase")
    assert inner["parent"] == outer["id"] and outer["parent"] == phase["id"]
    assert phase["kind"] == "phase" and phase["parent"] is None
    assert phase["start"] == timer.start and later["parent"] not in (phase["id"], None)
    assert outer["start"] <= inner["start"] <= inner["end"] <= outer["end"] <= phase["end"]
    assert len({r["id"] for r in rows}) == len(rows)


def test_a_span_from_a_second_thread():
    timer = _timer()
    with timer.recording():
        with span("starter"):
            t = threading.Thread(target=carried(lambda: span("carried").__enter__().__exit__()),
                                 name="producer")
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
        u = threading.Thread(target=lambda: add_span("loose", time.monotonic()))
        u.start()
        u.join(timeout=30)
        assert not u.is_alive()
    rows = _rows(timer)
    starter, carried_row = _by_name(rows, "starter"), _by_name(rows, "carried")
    assert carried_row["parent"] == starter["id"] and carried_row["thread"] == "producer"
    assert starter["thread"] == threading.current_thread().name
    assert _by_name(rows, "loose")["parent"] == timer._phase  # no carrier: the phase


def test_counters_from_many_threads():
    """More threads than cores, a short switch interval: no update lost."""
    timer = _timer()
    n_threads, n_each = 4 * (os.cpu_count() or 2), 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with timer.recording():
            def work():
                for _ in range(n_each):
                    count("hits")
                    count("bytes", 3)
                    with span("tick"):
                        pass
            threads = [threading.Thread(target=carried(work)) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert timer.counters == {"hits": n_threads * n_each, "bytes": 3 * n_threads * n_each}
    assert sum(r["name"] == "tick" for r in _rows(timer)) == n_threads * n_each


def test_a_span_closed_by_an_exception():
    timer = _timer()
    with timer.recording():
        with pytest.raises(ValueError):
            with span("boom"):
                raise ValueError("inside")
        with span("after"):
            pass
    rows = _rows(timer)
    boom = _by_name(rows, "boom")
    assert boom["end"] >= boom["start"]
    assert _by_name(rows, "after")["parent"] == boom["parent"]  # boom left the stack


def test_without_a_recorder_spans_time_and_record_nothing():
    timer = _timer()
    with span("alone") as s:
        count("nothing")
    assert s.seconds >= 0 and timer.spans == [] and timer.counters == {}
    with timer.recording():
        pass
    with span("after the command"):
        count("nothing")
    assert timer.spans == [] and timer.counters == {} and timing._current is None


def test_gc_hook_counts_and_is_removed():
    timer = _timer()
    with timer.recording():
        assert timer._gc_hook in gc.callbacks
        gc.collect()
    assert timer._gc_hook not in gc.callbacks
    assert timer.gc_collections[2] >= 1 and timer.gc_seconds[2] >= 0
    assert any(r["kind"] == "gc" and r["name"] == "gc.gen2" for r in _rows(timer))


def test_the_line_is_json_within_the_command():
    timer = _timer()
    with timer.recording():
        with span("a"):
            count("c", 7)
        timer.pelapsed("Phase")
        gc.collect()
    line = json.loads(timer.spans_line())
    assert line["clock"] == "monotonic" and line["command"] == timer.command
    assert line["fields"] == list(timing.SPAN_FIELDS) and line["counters"] == {"c": 7}
    assert len(line["gc"]["collections"]) == len(line["gc"]["seconds"]) == 3
    for row in line["spans"]:
        r = dict(zip(line["fields"], row))
        assert line["start"] <= r["start"] <= r["end"] <= line["end"], r
    assert _timer().command != timer.command


def _call_host(tmp_path, capsys, *extra):
    inputs = [shutil.copy(os.path.join(D, n), tmp_path / n) for n in ("ref.fa", "vars.vcf",
                                                                        "reads.fa")]
    inputs = [str(p) for p in inputs]
    assert cli.main(["index", "--backend", "host", "-b", "1", *inputs]) == 0
    capsys.readouterr()
    assert cli.main(["call", "--backend", "host", "-b", "1", *extra, *inputs]) == 0
    return capsys.readouterr()


def _spans_line(err):
    lines = [ln for ln in err.splitlines() if ln.startswith(SPANS)]
    assert len(lines) == 1
    line = json.loads(lines[0][len(SPANS):])
    line["rows"] = [dict(zip(line["fields"], row)) for row in line["spans"]]
    return line


def test_call_host_records_every_span(tmp_path, capsys):
    out = _call_host(tmp_path, capsys)
    with open(GOLDEN) as f:
        assert out.out == f.read()
    line = _spans_line(out.err)
    rows = line["rows"]
    names = {r["name"] for r in rows if r["kind"] == "span"}
    assert PASS2 | COUNT | {"index.load"} <= names
    phase = next(r for r in rows if r["kind"] == "phase"
                 and r["name"].startswith("VCF parsing and genotyping"))
    consumer = [r for r in rows if r["name"] in CONSUMER]
    assert all(phase["start"] <= r["start"] <= r["end"] <= phase["end"] for r in consumer)
    assert sum(r["end"] - r["start"] for r in consumer) <= phase["end"] - phase["start"]
    n_vars = int(re.search(r"\((\d+) variants\)", phase["name"]).group(1))
    assert line["counters"]["pass2.records"] == n_vars
    assert line["counters"]["pass2.batches"] >= 1
    windows = int(re.search(r"count\] (\d+) k-mer occurrences", out.err).group(1))
    assert line["counters"]["count.windows"] == windows
    producer = {r["thread"] for r in rows
                if r["name"] in {"pass2.scan", "pass2.gt_parse", "pass2.extract"}}
    assert producer and threading.current_thread().name not in producer
    counters = line["counters"]
    assert (counters.get("pass2.native_records", 0) + counters.get("pass2.fallback_records", 0)
            == counters["pass2.records"])
    load = _by_name(rows, "index.load")
    assert load["parent"] == _by_name(rows, "Index loaded")["id"]


def test_call_host_searches_the_exact_map(tmp_path, capsys, monkeypatch):
    """Coverage's exact-map queries take the native search: the sorted
    key view is built on the consumer's thread (``pass2.kmap_view``)
    before its first wait ends, and only the probes whose canonical form
    is not pure ACGT (the data holds NUL-truncated ones) take the per-key
    path."""
    from malva_tpu_torch.index.kmap import KMAP
    from malva_tpu_torch.ops.seq import canonical, is_acgt, truncate_at_nul

    probes = []
    get_counts = KMAP.get_counts
    monkeypatch.setattr(KMAP, "get_counts",
                        lambda self, kmers: probes.append(kmers) or get_counts(self, kmers))
    out = _call_host(tmp_path, capsys)
    with open(GOLDEN) as f:
        assert out.out == f.read()
    line = _spans_line(out.err)
    rows = line["rows"]
    view = _by_name(rows, "pass2.kmap_view")
    first_wait = min((r for r in rows if r["name"] == "pass2.wait"), key=lambda r: r["start"])
    assert view["thread"] == first_wait["thread"] == threading.current_thread().name
    assert view["end"] <= first_wait["end"]
    pure = np.concatenate([is_acgt(truncate_at_nul(canonical(p))) for p in probes])
    counters = line["counters"]
    assert counters["kmap.dict_queries"] == int((~pure).sum()) < 0.01 * pure.shape[0]
    assert counters["kmap.packed_queries"] >= int(pure.sum()) > 0


def test_stderr_lines_read_as_before(tmp_path, capsys):
    """The benchmark's patterns match the phase lines, and nothing of the
    spans line; every other line keeps its form."""
    err = _call_host(tmp_path, capsys).err
    spans_line = next(ln for ln in err.splitlines() if ln.startswith(SPANS))
    for pattern in (bench_record.PHASE, bench_record.UPLOAD, bench_record.LANES):
        assert pattern.search(spans_line) is None
    phases = [bench_record.phase_name(m.group(1)) for m in bench_record.PHASE.finditer(err)]
    assert phases == ["Index loaded", "Reference processed", "Sample k-mer counting",
                      "BF weights created", "VCF parsing and genotyping"]
    form = re.compile(
        r"\[malva-tpu-torch/[^\]]+\] (Execution Time|Time elapsed|Used CPU-time elapsed) "
        r"[0-9.e+-]+s|\[malva-tpu-torch/[^\]]+\] Maximum memory used \d+Mb|"
        r"\[malva-tpu-torch/count\] \d+ k-mer occurrences, \d+ distinct, \d+ past ci=2|"
        r"\[malva-tpu-torch/metrics\] main returned at [0-9.]+ s \(epoch\); the process exits "
        r"after|" + re.escape(SPANS) + r"\{.*\}")
    for ln in err.splitlines():
        if ln.startswith("[malva-tpu-torch/"):
            assert form.fullmatch(ln), ln
    assert err.splitlines()[-1].startswith("[malva-tpu-torch/metrics] main returned at")


def test_device_route_upload_spans_and_bytes(capsys):
    """On CPU tensors: the upload's parts are its spans, its bytes the
    arrays', and the ``call step:`` line keeps its form."""
    from malva_tpu_torch.index import device as tdev

    cfg = Config(fasta_path=os.path.join(D, "ref.fa"), vcf_path=os.path.join(D, "vars.vcf"),
                 sample_path=os.path.join(D, "reads.fa"), bf_size=1 << 20, backend="cuda")
    index = tp.build_index(cfg, device="cpu")
    got = io.StringIO()
    timer = PhaseTimer("malva-tpu-torch", out=sys.stderr)
    with timer.recording():
        stats = tp.call(cfg, index, got, timer, device="cpu")
    with open(GOLDEN) as f:
        assert got.getvalue() == f.read()
    rows = _rows(timer)
    parts = stats["upload_parts"]
    for part in ("table", "minifilter", "copy", "pack"):
        r = _by_name(rows, f"upload.{part}")
        assert parts[f"{part}_s"] == r["end"] - r["start"]
        assert r["parent"] == _by_name(rows, "step.upload")["id"]
    up, wb = _by_name(rows, "step.upload"), _by_name(rows, "step.writeback")
    assert stats["upload_s"] == up["end"] - up["start"]
    assert stats["writeback_s"] == wb["end"] - wb["start"]
    assert {"count.read", "count.piece", "count.merge"} <= {r["name"] for r in rows}
    # the bytes that cross: the Bloom and context words, the counters, the
    # bucket table's keys and values (4 bytes each) and the mini-filter's
    # rows and bits (8 bytes each)
    keys, rows_, vals = tdev.device_map_entries(index, cfg)
    table = tdev.BucketTable(keys, cfg.k, rows=rows_)
    mf_rows, _ = tdev.minifilter_rows(table.key_hashes, cfg.bf_size)
    words = cfg.bf_size // 32
    want = 4 * (2 * words + len(index.bf.counts) + table.bucket_keys.size + table.vals.size)
    assert timer.counters["upload.h2d_bytes"] == want + 16 * mf_rows.shape[0]
    err = capsys.readouterr().err
    step = next(ln for ln in err.splitlines() if "call step:" in ln)
    assert re.fullmatch(
        r"\[malva-tpu-torch/metrics\] call step: \d+ distinct k-mers in \d+ steps, step time "
        r"None ms \(K1 launcher events\), rate not measured; index upload [0-9.e+-]+ s \(table "
        r"[0-9.e+-]+ s, minifilter [0-9.e+-]+ s, copy [0-9.e+-]+ s, pack [0-9.e+-]+ s\), "
        r"write-back [0-9.e+-]+ s", step)
    assert float(bench_record.UPLOAD.search(step).group(1)) == float(f"{stats['upload_s']:.6g}")
    assert int(bench_record.LANES.search(step).group(1)) == stats["rows"]


def test_profile_dir_shows_the_spans(tmp_path, capsys):
    """Under ``--profile-dir`` each span timed by a block is a range of
    the trace (``add_span``'s, recorded after the fact, are not)."""
    prof = tmp_path / "prof"
    out = _call_host(tmp_path, capsys, "--profile-dir", str(prof))
    with open(GOLDEN) as f:
        assert out.out == f.read()
    (trace,) = prof.glob("*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"pass2.coverage", "pass2.format", "count.piece", "index.load"} <= names


def test_spans_only_under_profile_dir(monkeypatch):
    """Without a trace no span opens a profiler range."""
    import torch.profiler

    def refuse(*a, **k):
        raise AssertionError("record_function without --profile-dir")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    timer = _timer()
    with timer.recording():
        with span("quiet"):
            pass
    assert _by_name(_rows(timer), "quiet")


def test_recorder_loads_no_torch():
    code = r"""
import sys

class _NoTorch:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "torch":
            raise ImportError(name)
        return None

sys.meta_path.insert(0, _NoTorch())
import io, json
from malva_tpu_torch.utils.timing import PhaseTimer, count, span
t = PhaseTimer("malva-tpu-torch", out=io.StringIO())
with t.recording():
    with span("a"):
        count("n", 2)
assert json.loads(t.spans_line())["counters"] == {"n": 2}
assert "torch" not in sys.modules
print("OK")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0 and res.stdout.strip() == "OK", res.stderr[-2000:]


def test_flat_batches_count_every_variant():
    """``pass2.records`` over the batches is the pass's variant count, and
    ``native_records`` and ``fallback_records`` add up to it (and the
    index's ``variants.*``)."""
    cfg = Config(fasta_path=os.path.join(D, "ref.fa"), vcf_path=os.path.join(D, "vars.vcf"),
                 sample_path=os.path.join(D, "reads.fa"), bf_size=1 << 20)
    from malva_tpu_torch.io.fasta import load_reference

    refs = load_reference(cfg.fasta_path, cfg.strip_chr)
    timer = _timer()
    with timer.recording():
        n = sum(len(f.all_vars) for f in tp._iter_extract_batches(cfg, refs, keep_absent=True))
        m = sum(len(f.all_vars) for f in tp._iter_extract_batches(cfg, refs, keep_absent=False))
    c = timer.counters
    assert c["pass2.records"] == n and c["variants.records"] == m
    for spans in ("pass2", "variants"):
        assert (c.get(f"{spans}.native_records", 0) + c.get(f"{spans}.fallback_records", 0)
                == c[f"{spans}.records"])
    names = {r["name"] for r in _rows(timer)}
    assert {"variants.scan", "variants.gt_parse", "variants.extract"} <= names
    assert np.all([r["end"] >= r["start"] for r in _rows(timer)])


EXTRACT = ("blocks", "units", "busy_us", "critical_us")


def _deployment(tmp_path, name):
    """A configuration of the benchmark's generator cut to a test's size:
    the panel as ``h100bench/tests/conftest.py tiny_haploid`` cuts it
    (6,000 bp, 3,000 records, 400 genomes of 48 lineages), the cohort to
    4,000 bp at its 2,504 columns.  -> (Config, reference)."""
    from h100bench.gen.cohort import freq_key, make_cohort
    from malva_tpu_torch.io.fasta import load_reference

    with open(os.path.join(REPO, "h100bench", "configs", f"{name}.json")) as f:
        conf = json.load(f)
    if name == "sarscov2-panel":
        conf.update({"length_bp": 6000, "records": 3000, "samples": 400,
                     "lineages": dict(conf["lineages"], n_lineages=48)})
    else:
        conf["length_bp"] = 4000
    cohort = make_cohort(conf, 3230000001, str(tmp_path))
    cfg = Config(fasta_path=cohort.fasta, vcf_path=cohort.vcf, sample_path=GOLDEN,
                 bf_size=1 << 20, freq_key=freq_key(conf), haploid=cohort.ploidy == 1)
    return cfg, load_reference(cfg.fasta_path, cfg.strip_chr)


def _extract_passes(cfg, refs):
    """Both passes' batches drawn whole under a recorder: its counters."""
    timer = _timer()
    with timer.recording():
        for keep_absent in (True, False):
            for _ in tp._iter_extract_batches(cfg, refs, keep_absent=keep_absent):
                pass
    return timer.counters


def test_one_chained_block_counts_one_block_a_pass(tmp_path):
    """The panel's records chain into one block: each pass extracts it
    once, as a unit of work for each 64 of its records, and its critical
    path is the block's wall, first unit to last."""
    c = _extract_passes(*_deployment(tmp_path, "sarscov2-panel"))
    for spans in ("pass2", "variants"):
        assert c[f"{spans}.native_records"] == c[f"{spans}.records"] == 3000
        assert c[f"{spans}.extract_blocks"] == 1
        assert c[f"{spans}.extract_units"] == -(-3000 // 64)
        assert c[f"{spans}.extract_busy_us"] >= c[f"{spans}.extract_critical_us"] > 0


def test_many_blocks_count_each_and_busy_bounds_critical(tmp_path):
    """The cohort's blocks are short: each runs whole, as one unit."""
    c = _extract_passes(*_deployment(tmp_path, "chr20-1kgp3"))
    for spans in ("pass2", "variants"):
        assert c[f"{spans}.extract_blocks"] > 1
        assert c[f"{spans}.extract_units"] == c[f"{spans}.extract_blocks"]
        assert c[f"{spans}.extract_busy_us"] >= c[f"{spans}.extract_critical_us"] > 0


def test_extract_counters_sum_over_batches(tmp_path, monkeypatch):
    """Cut into batches of a few blocks, a pass counts every native
    call's blocks, busy and critical time, and the blocks are the one
    batch's."""
    from malva_tpu_torch.utils import native

    cfg, refs = _deployment(tmp_path, "chr20-1kgp3")
    whole = _extract_passes(cfg, refs)
    calls = []
    extract_arrays = native.extract_arrays

    def recorded(*args, **kw):
        res = extract_arrays(*args, **kw)
        calls.append(res[2])
        return res

    monkeypatch.setattr(native, "extract_arrays", recorded)
    monkeypatch.setattr(tp, "EXTRACT_VARS", 16)
    c = _extract_passes(cfg, refs)
    assert c["pass2.batches"] > 1 and len(calls) == c["pass2.batches"] + c["variants.batches"]
    for key in EXTRACT:
        assert sum(call[key] for call in calls) == sum(
            c[f"{spans}.extract_{key}"] for spans in ("pass2", "variants"))
    for spans in ("pass2", "variants"):
        assert c[f"{spans}.extract_blocks"] == whole[f"{spans}.extract_blocks"]
        assert c[f"{spans}.extract_critical_us"] <= c[f"{spans}.extract_busy_us"]


def test_python_extraction_counts_no_blocks(tmp_path, monkeypatch):
    """Without the library, the records are the Python path's
    ``fallback_records`` and its extraction is Python's: no
    ``extract_*`` counter is written."""
    from malva_tpu_torch.utils import native

    monkeypatch.setattr(native, "load", lambda: None)
    c = _extract_passes(*_deployment(tmp_path, "sarscov2-panel"))
    for spans in ("pass2", "variants"):
        assert c[f"{spans}.fallback_records"] == c[f"{spans}.records"] == 3000
        assert not [k for k in c if k.startswith(f"{spans}.extract_")]
