"""Bloom-filter and counter updates on tensors, plus the uint32 storage rule.

Device arrays (Bloom words, counters, bucket keys) are stored as
``int32`` tensors holding uint32 bit patterns: that is what the CUDA
kernels read and ``atomicAdd``/``atomicOr`` into as ``unsigned int``.
The plain versions widen to int64 lanes in ``[0, 2^32)`` to compute
(:func:`lanes`) and narrow back exactly (:func:`storage`).

``scatter_add_u32`` and ``bloom_set`` are the counterparts of
``malva_tpu/ops/bloom_jax.py:48,59``.  On a GPU ``bloom_set`` is an
``atomicOr`` inside the ref-scan kernel; the TPU's sort+dedup workaround
is not carried over.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def lanes(t: torch.Tensor) -> torch.Tensor:
    """int32 storage (uint32 bits) -> int64 lanes in [0, 2^32)."""
    return t.to(torch.int64) & M32


def storage(x: torch.Tensor) -> torch.Tensor:
    """int64 lanes in [0, 2^32) -> int32 storage with the same bits."""
    return (((x & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def from_u32(a: np.ndarray, device) -> torch.Tensor:
    """Host uint32 array -> int32 storage tensor on ``device``; always a
    copy, so in-place kernels never write into the host array."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a.view(np.int32)).to(device, copy=True)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 storage tensor -> host uint32 array (a fresh, writable copy)."""
    return t.detach().cpu().numpy().view(np.uint32).copy()


def scatter_add_u32(counts: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                    mask: torch.Tensor) -> None:
    """counts[idx] += vals where mask, duplicates accumulated, mod 2^32,
    in place.  counts and vals are int32 storage."""
    counts.index_add_(0, idx[mask], vals[mask])


def bloom_set(words: torch.Tensor, word_idx: torch.Tensor, bit: torch.Tensor,
              mask: torch.Tensor) -> None:
    """words[word_idx] |= 1 << bit where mask, in place (scatter-OR).

    Plain version: the distinct (word, bit) pairs are summed per word,
    which equals their OR, then OR-ed into the current words."""
    flat = torch.unique(word_idx[mask] * 32 + bit[mask])
    if flat.numel() == 0:
        return
    uw, inv = torch.unique(flat >> 5, return_inverse=True)
    acc = torch.zeros(uw.shape[0], dtype=torch.int64, device=words.device)
    acc.index_add_(0, inv, torch.ones_like(flat) << (flat & 31))
    words[uw] = storage(lanes(words[uw]) | acc)
