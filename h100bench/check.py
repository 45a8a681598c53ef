"""The comparison that decides ``correct``: what the program wrote, read
back and held against the plain reference.

Two numbers, each an exact comparison (limit 0):

* ``index_diff``: the set bits of the alternate and context filters and
  the exact map's keys in the index file that set-up's ``index`` wrote,
  against the reference's, counted as the size of each symmetric
  difference, summed;
* ``vcf_diff``: the records of the checked samples' VCFs (every line
  after the header) that differ from the reference's, with a missing or
  extra line counted as one.
"""

from __future__ import annotations

import numpy as np

from .reference.malva import Index, key_view

LIMITS = {"index_diff": 0, "vcf_diff": 0}


def _set_bits(nz: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Sorted bit positions of a filter stored as its nonzero words."""
    vals = np.asarray(vals, dtype=np.uint32)
    b = np.unpackbits(vals.view(np.uint8).reshape(-1, 4), axis=1, bitorder="little")
    w, bit = np.nonzero(b)
    return np.sort(np.asarray(nz, dtype=np.uint64)[w] * np.uint64(32) + bit.astype(np.uint64))


def index_diff(path: str, ref: Index) -> int:
    with np.load(path) as z:
        alt = _set_bits(z["bf_words_nz"], z["bf_words_nzv"])
        ctx = _set_bits(z["ctx_words_nz"], z["ctx_words_nzv"])
        keys = np.unique(key_view(np.asarray(z["kmap_keys"], dtype=np.uint8)))
        sizes = (int(z["bf_size"]), int(z["ctx_size"]))
    if sizes != (ref.size, ref.size):
        return alt.shape[0] + ctx.shape[0] + keys.shape[0] + 1
    if keys.dtype != ref.map_keys.dtype:
        return alt.shape[0] + ctx.shape[0] + keys.shape[0] + ref.map_keys.shape[0]
    return (np.setxor1d(alt, ref.alt_bits).shape[0] + np.setxor1d(ctx, ref.ctx_bits).shape[0]
            + np.setxor1d(keys, ref.map_keys).shape[0])


def vcf_records(path: str) -> list:
    with open(path) as f:
        return [ln.rstrip("\n") for ln in f if not ln.startswith("#")]


def vcf_diff(got: list, want: list) -> int:
    return sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
