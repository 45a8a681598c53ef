"""Phase timing/observability (mirrors pelapsed, reference main.cpp:93-115).

Per-phase wall time, cumulative wall time, user-CPU time and peak RSS to
stderr; stdout stays pure data.
"""

from __future__ import annotations

import resource
import sys
import time


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
