"""The device mesh of the sharded index.

Counterpart of ``malva_tpu/parallel/mesh.py:17``.  A mesh is an ordered
tuple of ``torch.device``s, one per index shard; one process drives all of
them, as one JAX process drives its mesh, and the shards exchange lanes
card to card (the routed call step's and the context scan's fixed slot
blocks on copy streams of their own, ``parallel/sharded_index.py Router``
and ``ScanRouter``).  A device may repeat: the shards then share it as
virtual shards, the counterpart of XLA's virtual CPU device count.

JAX starts every device when its backend starts; torch makes a card's
CUDA context the first time something touches the card.  Where a run is
about to shard over several cards, :class:`CardStartup` makes their
contexts in a background thread while the host works on (the variant
pass, the sample counting), and the mesh joins it where it first needs
the cards (``backend.start_cards``, ``pipeline._route``).
"""

from __future__ import annotations

import ctypes
import sys
import threading
import time

import torch

Mesh = tuple  # tuple[torch.device, ...]
TAG = "malva-tpu-torch"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """The first ``n_devices`` CUDA devices (all of them by default), or
    the first ``n_devices`` of an explicit ``devices`` list, which may
    repeat one device (``[torch.device("cpu")] * 4``)."""
    if devices is None:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise RuntimeError(f"a mesh of {n} CUDA devices needs that many; {count} present")
        return tuple(torch.device("cuda", i) for i in range(n))
    mesh = tuple(torch.device(d) for d in devices)[:n_devices]
    if not mesh or (n_devices is not None and len(mesh) != n_devices):
        raise ValueError(f"a mesh of {n_devices} devices from {len(devices)} given")
    if len({d.type for d in mesh}) != 1:
        raise ValueError(f"mesh devices must be of one type, got {mesh}")
    return mesh


def cards_of(mesh) -> list:
    """The distinct devices of a mesh, in mesh order."""
    return list(dict.fromkeys(mesh))


def retain_primary_contexts(cards) -> list:
    """Make each card's primary CUDA context through ``libcuda``
    (``cuDevicePrimaryCtxRetain``), the context torch's runtime then uses,
    each card in a thread of its own after one ``cuInit``.  Each ctypes
    call releases the GIL, so the host's Python work goes on meanwhile.
    Peer access between the cards is left to
    ``parallel/sharded_index.py enable_peer``.
    Returns each card's wall in seconds; raises the first error met."""
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuInit.argtypes = [ctypes.c_uint]
    cuda.cuDeviceGet.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    cuda.cuDevicePrimaryCtxRetain.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
    for fn in (cuda.cuInit, cuda.cuDeviceGet, cuda.cuDevicePrimaryCtxRetain):
        fn.restype = ctypes.c_int

    def check(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{what} failed with CUresult {rc}")

    check(cuda.cuInit(0), "cuInit")
    walls, errors = [0.0] * len(cards), [None] * len(cards)

    def start(i: int) -> None:
        t0 = time.perf_counter()
        try:
            dev, ctx = ctypes.c_int(), ctypes.c_void_p()
            check(cuda.cuDeviceGet(ctypes.byref(dev), cards[i].index),
                  f"cuDeviceGet({cards[i]})")
            check(cuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                  f"cuDevicePrimaryCtxRetain({cards[i]})")
        except Exception as e:  # raised below, in the calling thread
            errors[i] = e
        finally:
            walls[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=start, args=(i,), name=f"malva-card-{d}")
               for i, d in enumerate(cards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return walls


class CardStartup:
    """The CUDA contexts of ``cards``, made in a background thread started
    at construction: the cards' primary contexts are made side by side
    (:func:`retain_primary_contexts`), then torch is set up on each card
    with a one-element tensor.  :meth:`join` waits for the thread, logs
    its wall, the slowest card's and the wait once, and raises in the
    joining thread any error the thread met.  The thread is no daemon: a
    process that ends without taking the mesh waits for it at exit rather
    than tear CUDA down under it."""

    def __init__(self, cards):
        self.cards = tuple(cards)
        self.error: Exception | None = None
        self.wall_s: float | None = None
        self.card_walls: list = []
        self.waited_s: float | None = None
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._run, name="malva-card-startup")
        self._thread.start()

    def _run(self) -> None:
        try:
            self.card_walls = retain_primary_contexts(self.cards)
            for d in self.cards:
                torch.ones(1, device=d)
            for d in self.cards:
                torch.cuda.synchronize(d)
        except Exception as e:  # raised again by join(), in the thread that needs the cards
            self.error = e
        finally:
            self.wall_s = time.perf_counter() - self._t0

    def join(self) -> None:
        if self.waited_s is None:
            t0 = time.perf_counter()
            self._thread.join()
            self.waited_s = time.perf_counter() - t0
            slowest = f"{max(self.card_walls):.6g} s" if self.card_walls else "not reached"
            print(f"[{TAG}/metrics] card start-up: {len(self.cards)} cards "
                  f"({', '.join(map(str, self.cards))}) started in a background thread in "
                  f"{self.wall_s:.6g} s (contexts side by side, the slowest "
                  f"card {slowest}); the mesh waited {self.waited_s:.6g} s for it",
                  file=sys.stderr)
        if self.error is not None:
            raise self.error
