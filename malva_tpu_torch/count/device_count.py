"""Sample k-mer sort-count on a torch device.

Counterpart of ``malva_tpu/count/device_count.py:64-136``
(``make_seq_sort_count_step``, ``device_seq_sorted_counts`` and the
``_compact_runs`` layout).  A raw read chunk, reads joined by 0xFF
separators, crosses to the device at one byte a base.  K3
(``ops.kernels.seq_pack``) writes each window's canonical 2-bit key and
validity flag; the step keeps the valid rows, sorts them and run-length
counts them on the device, and only the distinct keys and their counts
cross back.  The TPU version ships the whole sorted chunk and its
boundary mask to the host and compacts there; since the invalid rows are
dropped here before the sort, its validity sort key and all-ones sentinel
are not needed.

``CountStats`` (``count/stats.py``) is an optional sink that says where a
count's time goes (``tools/demo_spill_wgs.py``): each piece's upload, K3,
sort-count and read-back, and the host parts of ``count/spill.py``.
Without one nothing is recorded and nothing waits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import kernels
from .stats import CountStats

SIGN = -(1 << 63)  # the int64 sign bit: flipped, signed order is unsigned order


def sort_count_rows(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Distinct rows of (N, w) int64 keys holding uint64 words, ascending
    as unsigned words (the order ``counter._merge_runs`` needs), and the
    number of times each occurs (int64).  One stable sort per word, from
    the last word to the first."""
    s = keys ^ SIGN
    n, w = s.shape
    if n == 0:
        return keys, torch.zeros(0, dtype=torch.int64, device=keys.device)
    order = None
    for j in range(w - 1, -1, -1):
        col = s[:, j] if order is None else s[order, j]
        idx = torch.sort(col, stable=True).indices
        order = idx if order is None else order[idx]
    s = s[order]
    boundary = torch.ones(n, dtype=torch.bool, device=s.device)
    boundary[1:] = (s[1:] != s[:-1]).any(dim=1)
    starts = torch.nonzero(boundary).squeeze(1)
    ends = torch.cat([starts[1:], torch.tensor([n], device=s.device)])
    return s[starts] ^ SIGN, ends - starts


@dataclass(frozen=True)
class SeqSortCountStep:
    """The sort-count step for raw chunks of up to ``chunk`` windows;
    with ``stats``, K3 and the sort-count are marked in it."""

    ref_k: int
    chunk: int
    device: torch.device
    stats: CountStats | None = None

    def __call__(self, seq: torch.Tensor, n_pos: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Distinct canonical keys of the valid windows among the first
        n_pos of a uint8 chunk on the device, and their counts."""
        if n_pos > self.chunk:
            raise ValueError(f"{n_pos} windows exceed the step's chunk of {self.chunk}")
        keys, valid = kernels.seq_pack(seq, n_pos, self.ref_k)
        self._mark("seq_pack")
        out = sort_count_rows(keys[valid])
        self._mark("sort_count")
        return out

    def _mark(self, part: str) -> None:
        if self.stats is not None:
            self.stats.mark(part)


def make_seq_sort_count_step(ref_k: int, chunk: int, device,
                             stats: CountStats | None = None) -> SeqSortCountStep:
    return SeqSortCountStep(ref_k, chunk, torch.device(device), stats)


def device_seq_sorted_counts(step: SeqSortCountStep,
                             seq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One raw chunk (up to step.chunk + step.ref_k - 1 bytes) through
    the step: ``(keys_u64 (M, ceil(ref_k/32)), counts int64)``, sorted
    ascending as unsigned words."""
    n_pos = seq.shape[0] - step.ref_k + 1
    if n_pos <= 0:
        return (np.zeros((0, (step.ref_k + 31) // 32), dtype=np.uint64),
                np.zeros(0, dtype=np.int64))
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    if not seq.flags.writeable:  # torch.from_numpy takes writable arrays only
        seq = seq.copy()
    if step.stats is not None:
        step.stats.begin_piece(step.device)
    seq_t = torch.from_numpy(seq).to(step.device)
    step._mark("upload")
    keys, counts = step(seq_t, n_pos)
    out = keys.cpu().numpy().view(np.uint64), counts.cpu().numpy()
    if step.stats is not None:
        step.stats.mark("read_back")
        step.stats.end_piece()
    return out
