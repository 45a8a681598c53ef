"""The device mesh of the sharded index.

Counterpart of ``malva_tpu/parallel/mesh.py:17``.  A mesh is an ordered
tuple of ``torch.device``s, one per index shard; one process drives all of
them, as one JAX process drives its mesh, and the shards exchange lanes
by tensor copies (``.to(device, non_blocking=True)``: peer to peer on a
multi-GPU host).  A device may repeat: the shards then share it as
virtual shards, the counterpart of XLA's virtual CPU device count.
"""

from __future__ import annotations

import torch

Mesh = tuple  # tuple[torch.device, ...]


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
