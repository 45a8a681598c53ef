"""Phase timing/observability (mirrors pelapsed, reference main.cpp:93-115).

Per-phase wall time, cumulative wall time, user-CPU time and peak RSS to
stderr; stdout stays pure data.  :func:`peak_rss_gb` and
:func:`process_age_s` read this process's own peak memory and age from
``/proc`` for the tools and the spill producer.
"""

from __future__ import annotations

import os
import resource
import sys
import time


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


class PhaseTimer:
    def __init__(self, tag: str = "malva-tpu", out=sys.stderr):
        self.tag = tag
        self.out = out
        self.start = time.monotonic()
        self.last = self.start
        self.cpu_start = resource.getrusage(resource.RUSAGE_SELF).ru_utime

    def pelapsed(self, phase: str, rollback: bool = False) -> None:
        now = time.monotonic()
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
