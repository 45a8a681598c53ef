"""XXH3_64bits, seed 0 and the default secret, for inputs of 17 to 128
bytes, in plain NumPy over rows of equal length.

Written from the XXH3 specification (``XXH3_len_17to128_64b``): the
length times PRIME64_1, plus one or more mixes of 16 input bytes against
16 bytes of the secret (each the 128-bit product of the two 64-bit halves
folded to 64 bits), then the avalanche.  The genotyper keys its Bloom
filters on this hash of each canonical k-mer (35 and 43 bytes here).
"""

from __future__ import annotations

import numpy as np

PRIME64_1 = np.uint64(0x9E3779B185EBCA87)
AVALANCHE = np.uint64(0x165667919E3779F9)
SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e")
LOW32 = np.uint64(0xFFFFFFFF)
S32 = np.uint64(32)


def _secret64(off: int) -> np.uint64:
    return np.frombuffer(SECRET, dtype="<u8", count=1, offset=off)[0]


def _read64(rows: np.ndarray, off: int) -> np.ndarray:
    return np.ascontiguousarray(rows[:, off : off + 8]).view("<u8")[:, 0]


def _fold(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Low 64 bits XOR high 64 bits of the 128-bit product a * b."""
    a0, a1, b0, b1 = a & LOW32, a >> S32, b & LOW32, b >> S32
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> S32) + (p01 & LOW32) + (p10 & LOW32)
    lo = (p00 & LOW32) | (mid << S32)
    hi = p11 + (p01 >> S32) + (p10 >> S32) + (mid >> S32)
    return lo ^ hi


def _mix16(rows: np.ndarray, at: int, sec: int) -> np.ndarray:
    return _fold(_read64(rows, at) ^ _secret64(sec), _read64(rows, at + 8) ^ _secret64(sec + 8))


def xxh3_64(rows: np.ndarray) -> np.ndarray:
    """(N,) uint64 hashes of the (N, L) uint8 rows, 17 <= L <= 128."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    n = rows.shape[1]
    if not 17 <= n <= 128:
        raise ValueError(f"rows of {n} bytes: only 17 to 128 are written here")
    acc = np.full(rows.shape[0], (n * int(PRIME64_1)) % (1 << 64), dtype=np.uint64)
    pairs = [(0, 0), (n - 16, 16)]
    if n > 32:
        pairs += [(16, 32), (n - 32, 48)]
    if n > 64:
        pairs += [(32, 64), (n - 48, 80)]
    if n > 96:
        pairs += [(48, 96), (n - 64, 112)]
    for at, sec in pairs:
        acc += _mix16(rows, at, sec)
    acc ^= acc >> np.uint64(37)
    acc *= AVALANCHE
    return acc ^ (acc >> S32)
