"""Where the device work runs: ``host``, ``cuda`` or ``auto``.

Counterpart of ``malva_tpu/pipeline.py:39-76``.  ``auto`` picks ``cuda``
when a CUDA device is present, the Bloom size meets the device contract
and the work clears the same floors as the JAX package; an explicit
``cuda`` without a device raises and never carries on on the host.
"""

from __future__ import annotations

import torch

from malva_tpu.utils.config import Config

from .ops.xxh3 import check_bloom_size

BACKENDS = ("auto", "host", "cuda")


def _size_ok(bf_size: int) -> bool:
    try:
        check_bloom_size(bf_size)
    except ValueError:
        return False
    return True


def resolve(cfg: Config, work: int | None = None, floor: int = 0) -> str:
    """``host`` or ``cuda`` for ``cfg.backend`` and a work size."""
    if cfg.backend == "host":
        return "host"
    if cfg.backend == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--backend cuda: no CUDA device is available")
        check_bloom_size(cfg.bf_size)
        return "cuda"
    if cfg.backend != "auto":
        raise ValueError(f"unknown backend {cfg.backend!r}; expected one of {BACKENDS}")
    if work is not None and work < floor:
        return "host"
    if not torch.cuda.is_available() or not _size_ok(cfg.bf_size):
        return "host"
    return "cuda"


def device_for(cfg: Config, work: int | None = None, floor: int = 0,
               device=None) -> torch.device | None:
    """The torch device of the device path, or None for the host path.
    An explicit ``device`` runs the device path there whatever the backend
    (tests drive it on the CPU with the kernels' plain versions)."""
    if device is not None:
        check_bloom_size(cfg.bf_size)
        return torch.device(device)
    return torch.device("cuda") if resolve(cfg, work, floor) == "cuda" else None
