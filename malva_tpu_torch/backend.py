"""Where the device work runs: ``host``, ``cuda`` or ``auto``.

Counterpart of ``malva_tpu/pipeline.py:39-76``.  ``auto`` picks ``cuda``
when a CUDA device is present, the Bloom size meets the device contract
and the work clears the same floors as the JAX package; an explicit
``cuda`` without a device raises and never carries on on the host.  Where
``cuda`` resolves on a host with several cards whose count divides the
Bloom words, the work runs sharded over all of them (:func:`mesh_for`,
the counterpart of ``malva_tpu/pipeline.py:937 _call_mesh``); where that
route may be taken, :func:`start_cards` starts the cards' CUDA contexts
in the background, as JAX starts all its devices with its backend.

torch is imported only where a device may be taken (``malva_tpu``
imports jax only there): the ``host`` backend never loads it.
"""

from __future__ import annotations

from .ops.xxh3 import check_bloom_size
from .utils.config import Config

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
    import torch

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


def device_for(cfg: Config, work: int | None = None, floor: int = 0, device=None):
    """The torch device of the device path, or None for the host path.
    An explicit ``device`` runs the device path there whatever the backend
    (tests drive it on the CPU with the kernels' plain versions)."""
    if device is None and resolve(cfg, work, floor) != "cuda":
        return None
    import torch

    check_bloom_size(cfg.bf_size)
    return torch.device(device if device is not None else "cuda")


def mesh_for(cfg: Config, work: int | None = None, floor: int = 0, mesh=None):
    """The mesh of the sharded device path, or None.  Without ``mesh``: all
    CUDA devices where the backend resolves to ``cuda``, more than one card
    is present and their count divides the Bloom words.  An explicit
    ``mesh`` (a list of devices, which may repeat one) is taken as given,
    as ``device`` is by :func:`device_for`."""
    if mesh is None and resolve(cfg, work, floor) != "cuda":
        return None
    from .parallel.mesh import make_mesh

    if mesh is not None:
        check_bloom_size(cfg.bf_size)
        mesh = make_mesh(devices=mesh)
        if (cfg.bf_size // 32) % len(mesh):
            raise ValueError(f"{cfg.bf_size // 32} Bloom words do not split into "
                             f"{len(mesh)} shards")
        return mesh
    n = _mesh_cards(cfg)
    return make_mesh(n) if n else None


def _mesh_cards(cfg: Config) -> int:
    """The number of cards of the sharded route where the backend resolves
    to ``cuda``: all of them, where there are several and their count
    divides the Bloom words; else 0.  Counted through NVML, which starts
    no card."""
    import torch

    n = torch.cuda.device_count()
    return n if n > 1 and (cfg.bf_size // 32) % n == 0 else 0


_startup = None  # the process's CardStartup, made once


def start_cards(cfg: Config, device=None, mesh=None):
    """Where the route may be a mesh of several cards, start their CUDA
    contexts in a background thread (``parallel.mesh.CardStartup``) and
    return it, for ``pipeline._route`` to join where the mesh first needs
    the cards: for the ``cuda`` and ``auto`` backends, every card, where
    :func:`mesh_for` would take them all, whatever the work (so an
    ``auto`` run below the work floors starts cards it then leaves
    unused), or the cards of an explicit mesh.  None for the host backend, an explicit
    device, one card, virtual shards of one card or a CPU mesh.  The
    thread is made once per process: ``build_index``, ``call`` and
    ``call_batch`` call this on entry, and a later call gets the running
    or finished start-up of the same cards."""
    global _startup
    if mesh is None and (device is not None or cfg.backend == "host"
                         or not _size_ok(cfg.bf_size)):
        return None
    import torch

    from .parallel.mesh import CardStartup, cards_of

    if mesh is not None:
        cards = cards_of(torch.device(d) for d in mesh)
    else:
        cards = [torch.device("cuda", i) for i in range(_mesh_cards(cfg))]
    if len(cards) < 2 or cards[0].type != "cuda":
        return None
    if _startup is None or not set(cards) <= set(_startup.cards):
        _startup = CardStartup(cards)
    return _startup
