"""The least time a kernel could take on one H100, from the work it was
given, and the published peaks it is held against.

The operation and byte counts are copies of ``chip_smoke.py``'s
(``bound``, ``xxh3_ops``, ``ascii_ops``, ``canonical_packed_ops``,
``rolling_ops`` and the per-lane and per-window counts of its K1 and K3
checks), with the data sheet's peaks as constants in place of a clock
read from ``nvidia-smi``.  A share of the roofline is this least time
over the kernel's measured time; the counts are the least the inputs
need, so a share cannot pass 100% unless the time leaves work out.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# integer instructions a second: each SM issues 128 lanes' worth a clock
# (4 schedulers, one warp instruction each), the same issue rate that
# gives 67 TFLOP/s of float32 counting an FMA as two flops
INT_OPS_PER_S = FP32_FLOPS_PER_S / 2


def bound_s(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least seconds, what sets them): the bytes over the memory rate or
    the integer instructions over the issue rate, whichever is longer."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / INT_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def xxh3_ops(length: int) -> int:
    """32-bit instructions XXH3_64 needs at the least for 17 <= length <=
    128 on input already in 32-bit words: 2 * ceil(length / 32) mix16
    rounds of 19, and 14 for the length seed and the avalanche."""
    return 19 * 2 * -(-length // 32) + 14


def ascii_ops(n: int) -> int:
    """ASCII words of n bases from their 2-bit codes: two a four bases."""
    return 2 * -(-n // 4)


def canonical_packed_ops(n: int) -> int:
    """Canonical form of n packed bases in registers: 12 a 16-base word."""
    return 12 * -(-n // 16)


def rolling_ops(n: int) -> int:
    """One base pushed into the rolling canonical key of an n-base window
    and the key read (csrc/lanes.cuh RollingKey)."""
    n16, w = -(-n // 16), -(-n // 32)
    return 4 + 4 * n16 + 6 + 3 * n16 + 2 * w + 2


def k1_least_s(lanes: int, k: int) -> tuple[float, str]:
    """K1 (``callstep_kernel``) over ``lanes`` counted contexts: per lane
    its packed context (12 B) and count (4 B), its Bloom row (8 B) and
    context word (4 B); the centre's canonical form, ASCII and hash, and
    23 for the Bloom index, bit test, mini-filter, bucket pair and rank.
    The work of the lanes that hit (their context's hash and the counters
    written) depends on the sample and is left out, so the bound is low
    by that much."""
    return bound_s(lanes * 28, lanes * (canonical_packed_ops(k) + ascii_ops(k) + xxh3_ops(k) + 23))


def k3_least_s(windows: int, pieces: int, ref_k: int) -> tuple[float, str]:
    """K3 (``seq_pack_kernel``) over ``windows`` windows in ``pieces``
    launches: each piece's bytes read once (its windows and ref_k - 1
    more), per window a key of ceil(ref_k / 32) words and a flag written,
    and one rolling step."""
    w = (ref_k + 31) // 32
    return bound_s(windows + pieces * (ref_k - 1) + windows * (8 * w + 1),
                   windows * rolling_ops(ref_k))
