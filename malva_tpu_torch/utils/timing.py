"""Phase timing/observability (mirrors pelapsed, reference main.cpp:93-115).

Per-phase wall time, cumulative wall time, user-CPU time and peak RSS to
stderr; stdout stays pure data.  :func:`peak_rss_gb` and
:func:`process_age_s` read this process's own peak memory and age from
``/proc`` for the tools and the spill producer.

A :class:`PhaseTimer` is also the command's recorder of spans and
counters.  While it records (:meth:`PhaseTimer.recording`, the CLI's
command), the module-level :func:`span`, :func:`add_span` and
:func:`count` reach it from any module and any thread; with no recorder
they time and count nothing but the span's own wall.  Stamps are
``time.monotonic()``.  :meth:`PhaseTimer.spans_line` is the record as
one JSON object.  Nothing here imports torch, except a span opened while
a ``torch.profiler`` trace runs (``profiling``).
"""

from __future__ import annotations

import functools
import gc
import itertools
import json
import os
import resource
import sys
import threading
import time
from contextlib import contextmanager

_current: "PhaseTimer | None" = None  # the recorder of the command in flight
_commands = itertools.count(1)

SPAN_FIELDS = ("id", "parent", "kind", "name", "thread", "start", "end")


def _vmhwm_kb() -> int | None:
    """``VmHWM`` of ``/proc/self/status`` in kB, or None where the kernel
    does not give it (gVisor's ``/proc``, as on the card's machine)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


def peak_rss_gb() -> float:
    """This process's peak resident memory in GB (kB / 1e6, ``ru_maxrss``'s
    unit): ``VmHWM`` of ``/proc/self/status``, which starts anew at exec,
    where the kernel gives it, else ``ru_maxrss`` (:func:`peak_rss_from`
    says which).  ``ru_maxrss`` keeps the peak of the process that
    exec'd into this one, a parent that vfork'd it included (Python's
    ``subprocess``), so where it is read, start the process from a fresh
    small one: a shell that forks it (``sh -c '"$@"; exit $?' sh ...``)."""
    kb = _vmhwm_kb()
    return (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss if kb is None else kb) / 1e6


def peak_rss_from() -> str:
    """``VmHWM`` or ``ru_maxrss``: where :func:`peak_rss_gb` reads."""
    return "ru_maxrss" if _vmhwm_kb() is None else "VmHWM"


def process_age_s() -> float | None:
    """Seconds since this process started (its start time in
    ``/proc/self/stat`` against ``/proc/uptime``; clock-tick precision,
    10 ms on Linux), or None without ``/proc``."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, IndexError, ValueError):
        return None
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


class Span:
    """One timed block (``with span(name) as s``; ``s.seconds`` after it),
    recorded into ``rec`` when there is one."""

    __slots__ = ("rec", "name", "opened", "start", "end", "_range")

    def __init__(self, rec: "PhaseTimer | None", name: str):
        self.rec, self.name, self._range = rec, name, None

    def __enter__(self) -> "Span":
        rec = self.rec
        if rec is not None:
            self.opened = rec._open()
            if rec.profiling:
                from torch.profiler import record_function

                self._range = record_function(self.name)
                self._range.__enter__()
        self.start = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.monotonic()
        if self._range is not None:
            self._range.__exit__(*exc)
        if self.rec is not None:
            self.rec._close(self.opened, self.name, self.start, self.end)

    @property
    def seconds(self) -> float:
        return self.end - self.start


def span(name: str) -> Span:
    """A block timed as span ``name`` of the command's recorder."""
    return Span(_current, name)


def add_span(name: str, start: float, end: float | None = None) -> None:
    """Record span ``name`` from ``start`` to ``end`` (now by default) on
    this thread's open span: for a generator, whose ``with`` block would
    hold its ``yield``.  It opens no profiler range."""
    rec = _current
    if rec is not None:
        rec._close(rec._open(), name, start, time.monotonic() if end is None else end)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the command's counter ``name``."""
    rec = _current
    if rec is not None:
        rec.count(name, n)


def carried(fn):
    """``fn``, to run on another thread with the span open here (or the
    phase) as the parent of its spans."""
    rec = _current
    if rec is None:
        return fn
    parent = rec._parent()

    @functools.wraps(fn)
    def run(*args, **kwargs):
        rec._local.root = parent
        return fn(*args, **kwargs)

    return run


class PhaseTimer:
    """The reference's phase lines, and the command's span-and-counter
    recorder.

    Each span is recorded as ``SPAN_FIELDS``: its id, its parent (the span
    open on its thread when it began; on a thread started through
    :func:`carried`, the span that started it; else the phase in flight),
    its kind (``phase``, ``span`` or ``gc``), name, thread and monotonic
    start and end.  Each ``pelapsed`` is a ``phase`` span from the last
    one.  While :meth:`recording`, a ``gc.callbacks`` hook keeps each
    generation's collections and seconds, and a ``gc`` span for each
    generation-2 collection."""

    def __init__(self, tag: str = "malva-tpu", out=sys.stderr):
        self.tag = tag
        self.out = out
        self.start = time.monotonic()
        self.last = self.start
        self.cpu_start = resource.getrusage(resource.RUSAGE_SELF).ru_utime
        self.command = f"{os.getpid()}.{next(_commands)}"
        self.profiling = False  # a torch.profiler trace runs: spans open its ranges
        self.spans: list = []
        self.counters: dict[str, int] = {}
        self.gc_collections = [0, 0, 0]
        self.gc_seconds = [0.0, 0.0, 0.0]
        self._ids = itertools.count(1)
        self._phase = next(self._ids)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._gc_t = 0.0

    def _parent(self) -> int:
        stack = getattr(self._local, "stack", None)
        if stack:
            return stack[-1]
        root = getattr(self._local, "root", None)
        return self._phase if root is None else root

    def _open(self) -> tuple[int, int]:
        """(id, parent) of a span opened now on this thread."""
        opened = (next(self._ids), self._parent())
        self._local.__dict__.setdefault("stack", []).append(opened[0])
        return opened

    def _close(self, opened: tuple[int, int], name: str, start: float, end: float) -> None:
        stack = getattr(self._local, "stack", ())
        if opened[0] in stack:  # a generator's span may close on another thread
            stack.remove(opened[0])
        self.spans.append([opened[0], opened[1], "span", name,
                           threading.current_thread().name, start, end])

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def _gc_hook(self, phase: str, info: dict) -> None:
        now = time.monotonic()
        if phase == "start":
            self._gc_t = now
            return
        g = info["generation"]
        self.gc_collections[g] += 1
        self.gc_seconds[g] += now - self._gc_t
        if g == 2:
            self.spans.append([next(self._ids), None, "gc", "gc.gen2",
                               threading.current_thread().name, self._gc_t, now])

    @contextmanager
    def recording(self, profiling: bool = False):
        """Make this the recorder that :func:`span` and :func:`count`
        reach, with the GC hook, for the block (a command's life)."""
        global _current
        prev, _current, self.profiling = _current, self, profiling
        gc.callbacks.append(self._gc_hook)
        try:
            yield self
        finally:
            gc.callbacks.remove(self._gc_hook)
            _current, self.profiling = prev, False

    def spans_line(self) -> str:
        """The record as one JSON object: the command's id, its start and
        this line's time, the spans (``fields``), the counters and the GC
        totals by generation."""
        return json.dumps({
            "command": self.command, "clock": "monotonic", "start": self.start,
            "end": time.monotonic(), "fields": SPAN_FIELDS, "spans": list(self.spans),
            "counters": dict(self.counters),
            "gc": {"collections": self.gc_collections, "seconds": self.gc_seconds}},
            separators=(",", ":"))

    def pelapsed(self, phase: str, rollback: bool = False) -> None:
        now = time.monotonic()
        self.spans.append([self._phase, None, "phase", phase, threading.current_thread().name,
                           self.last, now])
        self._phase = next(self._ids)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        print(f"[{self.tag}/{phase}] Execution Time {now - self.last:.4g}s", file=self.out)
        print(f"[{self.tag}/{phase}] Time elapsed {now - self.start:.4g}s", file=self.out)
        print(
            f"[{self.tag}/{phase}] Used CPU-time elapsed {ru.ru_utime - self.cpu_start:.4g}s",
            file=self.out,
        )
        print(
            f"[{self.tag}/{phase}] Maximum memory used {ru.ru_maxrss // 1024}Mb",
            file=self.out,
        )
        print("\r" if rollback else "", end="\n" if not rollback else "", file=self.out)
        self.last = now
