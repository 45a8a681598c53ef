"""Carry index state across from the JAX package.

The port's counterpart of loading weights: the arrays of a
``malva_tpu.index.device.DeviceIndex`` (as numpy) become the port's
``DeviceIndex`` on a given torch device, so both call steps can be run
on the identical index state.
"""

from __future__ import annotations

import numpy as np

from .index.device import DeviceIndex
from .ops.bloom import from_u32

ARRAYS = ("bf_packed", "bf_counts", "ctx_words", "kmap_keys", "kmap_vals")
SCALARS = ("size_bits", "k", "ref_k", "n_buckets", "minifilter")


def device_index_from_arrays(arrays: dict[str, np.ndarray], device,
                             table=None) -> DeviceIndex:
    """``arrays`` holds the five uint32 arrays named in ``ARRAYS`` and the
    scalars named in ``SCALARS``; ``table`` is the host BucketTable that
    ``write_back`` needs (optional)."""
    missing = [n for n in ARRAYS + SCALARS if n not in arrays]
    if missing:
        raise KeyError(f"index arrays missing: {missing}")
    tensors = {n: from_u32(np.asarray(arrays[n], dtype=np.uint32), device) for n in ARRAYS}
    return DeviceIndex(
        **tensors,
        size_bits=int(arrays["size_bits"]), k=int(arrays["k"]), ref_k=int(arrays["ref_k"]),
        n_buckets=int(arrays["n_buckets"]), table=table,
        minifilter=bool(arrays["minifilter"]),
    )
