"""Where a count's time goes: ``CountStats``, an optional sink of the
sample counters (``count/spill.py``, ``count/counter.py
iter_device_runs``) that ``tools/demo_spill_wgs.py`` reads.

It imports no torch, so the host route's count runs without it; a device
piece's marks import torch where the piece lies on a card.  Without a
sink nothing is recorded and nothing waits.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class CountStats:
    """Seconds by part of a count, and its pieces.

    Host parts add host-clock intervals (``timed``, ``timed_iter``).  A
    device piece is cut by marks, each closing the part named by it: CUDA
    events on a card, the host clock elsewhere.  ``end_piece`` waits for
    the last event, which the piece's read-back has already waited for,
    and adds the intervals between marks to their parts, and the piece's
    host wall to ``pieces``.  The spill counter sets ``windows``,
    ``segments`` and ``spill_bytes`` once it has counted."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.pieces = 0
        self.windows = self.segments = self.spill_bytes = 0
        self._marks: list = []
        self._piece_t0 = 0.0
        self._device, self._on_card = None, False

    def add(self, part: str, seconds: float) -> None:
        self.seconds[part] = self.seconds.get(part, 0.0) + seconds

    @contextmanager
    def timed(self, part: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(part, time.perf_counter() - t0)

    def timed_iter(self, part: str, items):
        """``items``, with the time spent getting each added to ``part``."""
        t0 = time.perf_counter()
        for item in items:
            self.add(part, time.perf_counter() - t0)
            yield item
            t0 = time.perf_counter()
        self.add(part, time.perf_counter() - t0)

    def begin_piece(self, device) -> None:
        """Open a piece on ``device`` (a torch device)."""
        self._piece_t0 = time.perf_counter()
        self._marks, self._device, self._on_card = [], device, device.type == "cuda"
        self.mark(None)

    def mark(self, part: str | None) -> None:
        if self._on_card:
            import torch

            at = torch.cuda.Event(enable_timing=True)
            at.record(torch.cuda.current_stream(self._device))
        else:
            at = time.perf_counter()
        self._marks.append((part, at))

    def end_piece(self) -> None:
        if self._on_card:
            self._marks[-1][1].synchronize()
        for (_, a), (part, b) in zip(self._marks, self._marks[1:]):
            self.add(part, a.elapsed_time(b) / 1e3 if self._on_card else b - a)
        self.add("pieces", time.perf_counter() - self._piece_t0)
        self.pieces += 1
