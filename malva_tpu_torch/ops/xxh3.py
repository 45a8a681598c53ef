"""XXH3_64bits (one-shot, seed=0, default secret), on the host and in torch.

The reference genotyper keys all of its probabilistic index structures on
``XXH3_64bits(canonical_kmer, k)`` (reference: bloom_filter.hpp:67-74), so
hash collisions are part of the observable output and every version here
matches the upstream XXH3 specification bit for bit.  The constants below
(primes and the 192-byte default secret) are the spec's published ones.

* :func:`xxh3_64` — numpy over a batch of equal-length byte strings shaped
  ``(N, L) uint8``, every length (the native library where it loads): the
  port's copy of ``malva_tpu/ops/xxh3.py``, the host path of index
  construction and the tests' oracle.
* :func:`xxh3_64_cols` — plain torch over byte columns, the counterpart of
  ``malva_tpu.ops.xxh3_jax`` and the plain version of the hashing inside
  the call-step and ref-scan kernels (``csrc/xxh3.cuh`` holds the device
  form, with native ``u64`` and ``__umul64hi``).  Every uint64 is carried
  as a ``(hi, lo)`` pair of 32-bit values held in ``int64`` tensors (torch
  has no add, shift or compare on ``uint32``/``uint64``), so every value
  stays in ``[0, 2^32)``: ``>>`` on ``int64`` sign-extends, so every right
  shift of a value that may have bit 63 set is masked; a 32x32 product can
  overflow signed ``int64``, and its bit pattern is still the unsigned
  product, so both halves are taken with masks.  Bit-exact with
  :func:`xxh3_64` at lengths 1..240 (parity-tested).
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Spec constants
# ---------------------------------------------------------------------------

PRIME32_1 = np.uint64(0x9E3779B1)
PRIME32_2 = np.uint64(0x85EBCA77)
PRIME32_3 = np.uint64(0xC2B2AE3D)
PRIME64_1 = np.uint64(0x9E3779B185EBCA87)
PRIME64_2 = np.uint64(0xC2B2AE3D27D4EB4F)
PRIME64_3 = np.uint64(0x165667B19E3779F9)
PRIME64_4 = np.uint64(0x85EBCA77C2B2AE63)
PRIME64_5 = np.uint64(0x27D4EB2F165667C5)
PRIME_MX1 = np.uint64(0x165667919E3779F9)  # XXH3 avalanche multiplier
PRIME_MX2 = np.uint64(0x9FB21C651E98DF25)  # rrmxmx multiplier

# The 192-byte canonical XXH3 default secret (spec constant).
KSECRET = bytes(
    [
        0xB8, 0xFE, 0x6C, 0x39, 0x23, 0xA4, 0x4B, 0xBE, 0x7C, 0x01, 0x81, 0x2C, 0xF7, 0x21, 0xAD, 0x1C,
        0xDE, 0xD4, 0x6D, 0xE9, 0x83, 0x90, 0x97, 0xDB, 0x72, 0x40, 0xA4, 0xA4, 0xB7, 0xB3, 0x67, 0x1F,
        0xCB, 0x79, 0xE6, 0x4E, 0xCC, 0xC0, 0xE5, 0x78, 0x82, 0x5A, 0xD0, 0x7D, 0xCC, 0xFF, 0x72, 0x21,
        0xB8, 0x08, 0x46, 0x74, 0xF7, 0x43, 0x24, 0x8E, 0xE0, 0x35, 0x90, 0xE6, 0x81, 0x3A, 0x26, 0x4C,
        0x3C, 0x28, 0x52, 0xBB, 0x91, 0xC3, 0x00, 0xCB, 0x88, 0xD0, 0x65, 0x8B, 0x1B, 0x53, 0x2E, 0xA3,
        0x71, 0x64, 0x48, 0x97, 0xA2, 0x0D, 0xF9, 0x4E, 0x38, 0x19, 0xEF, 0x46, 0xA9, 0xDE, 0xAC, 0xD8,
        0xA8, 0xFA, 0x76, 0x3F, 0xE3, 0x9C, 0x34, 0x3F, 0xF9, 0xDC, 0xBB, 0xC7, 0xC7, 0x0B, 0x4F, 0x1D,
        0x8A, 0x51, 0xE0, 0x4B, 0xCD, 0xB4, 0x59, 0x31, 0xC8, 0x9F, 0x7E, 0xC9, 0xD9, 0x78, 0x73, 0x64,
        0xEA, 0xC5, 0xAC, 0x83, 0x34, 0xD3, 0xEB, 0xC3, 0xC5, 0x81, 0xA0, 0xFF, 0xFA, 0x13, 0x63, 0xEB,
        0x17, 0x0D, 0xDD, 0x51, 0xB7, 0xF0, 0xDA, 0x49, 0xD3, 0x16, 0x55, 0x26, 0x29, 0xD4, 0x68, 0x9E,
        0x2B, 0x16, 0xBE, 0x58, 0x7D, 0x47, 0xA1, 0xFC, 0x8F, 0xF8, 0xB8, 0xD1, 0x7A, 0xD0, 0x31, 0xCE,
        0x45, 0xCB, 0x3A, 0x8F, 0x95, 0x16, 0x04, 0x28, 0xAF, 0xD7, 0xFB, 0xCA, 0xBB, 0x4B, 0x40, 0x7E,
    ]
)

_SECRET = np.frombuffer(KSECRET, dtype=np.uint8)


def _sec64(off: int) -> np.uint64:
    """Little-endian uint64 read of the default secret at byte offset."""
    return np.frombuffer(KSECRET[off : off + 8], dtype="<u8")[0]


def _sec32(off: int) -> np.uint64:
    return np.uint64(np.frombuffer(KSECRET[off : off + 4], dtype="<u4")[0])


# ---------------------------------------------------------------------------
# uint64 helpers (NumPy wraps unsigned arithmetic mod 2**64)
# ---------------------------------------------------------------------------

_M32 = np.uint64(0xFFFFFFFF)


def _rd64(a: np.ndarray, off: int) -> np.ndarray:
    """Vectorized little-endian uint64 read at byte offset `off` of (N,L)."""
    return np.ascontiguousarray(a[:, off : off + 8]).view("<u8")[:, 0]


def _rd32(a: np.ndarray, off: int) -> np.ndarray:
    return np.ascontiguousarray(a[:, off : off + 4]).view("<u4")[:, 0].astype(np.uint64)


def _mul128(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Full 64x64 -> 128-bit product as (lo64, hi64), via 32-bit limbs."""
    a_lo = a & _M32
    a_hi = a >> np.uint64(32)
    b_lo = b & _M32
    b_hi = b >> np.uint64(32)
    lo_lo = a_lo * b_lo
    mid1 = a_lo * b_hi
    mid2 = a_hi * b_lo
    hi_hi = a_hi * b_hi
    cross = (lo_lo >> np.uint64(32)) + (mid1 & _M32) + (mid2 & _M32)
    lo = (lo_lo & _M32) | (cross << np.uint64(32))
    hi = hi_hi + (mid1 >> np.uint64(32)) + (mid2 >> np.uint64(32)) + (cross >> np.uint64(32))
    return lo, hi


def _mul128_fold64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lo, hi = _mul128(a, b)
    return lo ^ hi


def _swap32(x: np.ndarray) -> np.ndarray:
    x = x & _M32
    return (
        ((x << np.uint64(24)) & np.uint64(0xFF000000))
        | ((x << np.uint64(8)) & np.uint64(0x00FF0000))
        | ((x >> np.uint64(8)) & np.uint64(0x0000FF00))
        | (x >> np.uint64(24))
    )


def _swap64(x: np.ndarray) -> np.ndarray:
    return (
        ((x & np.uint64(0x00000000000000FF)) << np.uint64(56))
        | ((x & np.uint64(0x000000000000FF00)) << np.uint64(40))
        | ((x & np.uint64(0x0000000000FF0000)) << np.uint64(24))
        | ((x & np.uint64(0x00000000FF000000)) << np.uint64(8))
        | ((x & np.uint64(0x000000FF00000000)) >> np.uint64(8))
        | ((x & np.uint64(0x0000FF0000000000)) >> np.uint64(24))
        | ((x & np.uint64(0x00FF000000000000)) >> np.uint64(40))
        | (x >> np.uint64(56))
    )


def _rotl64(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _xxh64_avalanche(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint64(33))
    h = h * PRIME64_2
    h = h ^ (h >> np.uint64(29))
    h = h * PRIME64_3
    h = h ^ (h >> np.uint64(32))
    return h


def _xxh3_avalanche(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint64(37))
    h = h * PRIME_MX1
    h = h ^ (h >> np.uint64(32))
    return h


def _rrmxmx(h: np.ndarray, length: int) -> np.ndarray:
    h = h ^ (_rotl64(h, 49) ^ _rotl64(h, 24))
    h = h * PRIME_MX2
    h = h ^ ((h >> np.uint64(35)) + np.uint64(length))
    h = h * PRIME_MX2
    return h ^ (h >> np.uint64(28))


def _mix16(a: np.ndarray, in_off: int, sec_off: int) -> np.ndarray:
    lo = _rd64(a, in_off) ^ _sec64(sec_off)
    hi = _rd64(a, in_off + 8) ^ _sec64(sec_off + 8)
    return _mul128_fold64(lo, hi)


# ---------------------------------------------------------------------------
# Length-specialized paths
# ---------------------------------------------------------------------------


def _len_0(n: int) -> np.ndarray:
    h = np.uint64(0) ^ _sec64(56) ^ _sec64(64)
    return np.full(n, _xxh64_avalanche(np.array([h], dtype=np.uint64))[0], dtype=np.uint64)


def _len_1to3(a: np.ndarray, length: int) -> np.ndarray:
    c1 = a[:, 0].astype(np.uint64)
    c2 = a[:, length >> 1].astype(np.uint64)
    c3 = a[:, length - 1].astype(np.uint64)
    combined = (c1 << np.uint64(16)) | (c2 << np.uint64(24)) | c3 | (np.uint64(length) << np.uint64(8))
    bitflip = (_sec32(0) ^ _sec32(4)).astype(np.uint64)
    return _xxh64_avalanche(combined ^ bitflip)


def _len_4to8(a: np.ndarray, length: int) -> np.ndarray:
    in1 = _rd32(a, 0)
    in2 = _rd32(a, length - 4)
    bitflip = _sec64(8) ^ _sec64(16)
    in64 = in2 + (in1 << np.uint64(32))
    return _rrmxmx(in64 ^ bitflip, length)


def _len_9to16(a: np.ndarray, length: int) -> np.ndarray:
    bitflip1 = _sec64(24) ^ _sec64(32)
    bitflip2 = _sec64(40) ^ _sec64(48)
    lo = _rd64(a, 0) ^ bitflip1
    hi = _rd64(a, length - 8) ^ bitflip2
    acc = np.uint64(length) + _swap64(lo) + hi + _mul128_fold64(lo, hi)
    return _xxh3_avalanche(acc)


def _len_17to128(a: np.ndarray, length: int) -> np.ndarray:
    acc = np.full(a.shape[0], np.uint64(length) * PRIME64_1, dtype=np.uint64)
    if length > 96:
        acc += _mix16(a, 48, 96) + _mix16(a, length - 64, 112)
    if length > 64:
        acc += _mix16(a, 32, 64) + _mix16(a, length - 48, 80)
    if length > 32:
        acc += _mix16(a, 16, 32) + _mix16(a, length - 32, 48)
    acc += _mix16(a, 0, 0) + _mix16(a, length - 16, 16)
    return _xxh3_avalanche(acc)


_MIDSIZE_START = 3
_MIDSIZE_LAST = 17


def _len_129to240(a: np.ndarray, length: int) -> np.ndarray:
    acc = np.full(a.shape[0], np.uint64(length) * PRIME64_1, dtype=np.uint64)
    nb = length // 16
    for i in range(8):
        acc += _mix16(a, 16 * i, 16 * i)
    acc = _xxh3_avalanche(acc)
    for i in range(8, nb):
        acc += _mix16(a, 16 * i, 16 * (i - 8) + _MIDSIZE_START)
    acc += _mix16(a, length - 16, 136 - _MIDSIZE_LAST)
    return _xxh3_avalanche(acc)


_STRIPE = 64
_ACC_INIT = np.array(
    [PRIME32_3, PRIME64_1, PRIME64_2, PRIME64_3, PRIME64_4, PRIME32_2, PRIME64_5, PRIME32_1],
    dtype=np.uint64,
)
_SECRET_MERGEACCS_START = 11
_SECRET_LASTACC_START = 7


def _accumulate512(acc: np.ndarray, a: np.ndarray, in_off: int, sec_off: int) -> None:
    # acc: (N, 8) uint64; updated in place.
    for i in range(8):
        data_val = _rd64(a, in_off + 8 * i)
        data_key = data_val ^ _sec64(sec_off + 8 * i)
        acc[:, i ^ 1] += data_val
        acc[:, i] += (data_key & _M32) * (data_key >> np.uint64(32))


def _scramble(acc: np.ndarray, sec_off: int) -> None:
    for i in range(8):
        x = acc[:, i]
        x = (x ^ (x >> np.uint64(47)) ^ _sec64(sec_off + 8 * i)) * PRIME32_1
        acc[:, i] = x


def _len_long(a: np.ndarray, length: int) -> np.ndarray:
    n = a.shape[0]
    secret_size = len(KSECRET)
    stripes_per_block = (secret_size - _STRIPE) // 8  # 16 for the default secret
    block_len = _STRIPE * stripes_per_block
    nb_blocks = (length - 1) // block_len

    acc = np.tile(_ACC_INIT, (n, 1))
    for b in range(nb_blocks):
        for s in range(stripes_per_block):
            _accumulate512(acc, a, b * block_len + s * _STRIPE, 8 * s)
        _scramble(acc, secret_size - _STRIPE)

    nb_stripes = ((length - 1) - block_len * nb_blocks) // _STRIPE
    for s in range(nb_stripes):
        _accumulate512(acc, a, nb_blocks * block_len + s * _STRIPE, 8 * s)
    # last stripe
    _accumulate512(acc, a, length - _STRIPE, secret_size - _STRIPE - _SECRET_LASTACC_START)

    result = np.full(n, np.uint64(length) * PRIME64_1, dtype=np.uint64)
    for i in range(4):
        sec_off = _SECRET_MERGEACCS_START + 16 * i
        result += _mul128_fold64(acc[:, 2 * i] ^ _sec64(sec_off), acc[:, 2 * i + 1] ^ _sec64(sec_off + 8))
    return _xxh3_avalanche(result)


def xxh3_64(a: np.ndarray) -> np.ndarray:
    """XXH3_64bits over a batch of equal-length inputs.

    Parameters
    ----------
    a : (N, L) uint8 array — N byte strings of identical length L.

    Returns
    -------
    (N,) uint64 — XXH3_64bits(row, L) for each row, bit-identical to the
    upstream C implementation (seed 0, default secret).
    """
    a = np.asarray(a, dtype=np.uint8)
    if a.ndim == 1:
        a = a[None, :]
    n, length = a.shape
    if n:
        from ..utils import native

        out = native.xxh3_batch(a)
        if out is not None:
            return out
    with np.errstate(over="ignore"):
        if length == 0:
            return _len_0(n)
        if length <= 3:
            return _len_1to3(a, length)
        if length <= 8:
            return _len_4to8(a, length)
        if length <= 16:
            return _len_9to16(a, length)
        if length <= 128:
            return _len_17to128(a, length)
        if length <= 240:
            return _len_129to240(a, length)
        return _len_long(a, length)


def xxh3_64_bytes(data: bytes) -> int:
    """Convenience scalar variant for single byte strings."""
    return int(xxh3_64(np.frombuffer(data, dtype=np.uint8)[None, :])[0])


# ---------------------------------------------------------------------------
# torch: u64 as a (hi, lo) pair of int64 lanes
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def _const(v64) -> tuple[int, int]:
    v64 = int(v64)
    return (v64 >> 32) & M32, v64 & M32


# -- u64-as-pair primitives ---------------------------------------------------


def _add(a, b):
    lo = a[1] + b[1]
    hi = (a[0] + b[0] + (lo >> 32)) & M32
    return hi, lo & M32


def _xor(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def _shr(a, r: int):
    if r == 0:
        return a
    if r < 32:
        return a[0] >> r, ((a[1] >> r) | (a[0] << (32 - r))) & M32
    return torch.zeros_like(a[0]), a[0] >> (r - 32)


def _shl(a, r: int):
    if r == 0:
        return a
    if r < 32:
        return ((a[0] << r) | (a[1] >> (32 - r))) & M32, (a[1] << r) & M32
    return (a[1] << (r - 32)) & M32, torch.zeros_like(a[1])


def _mul32(a, b):
    """u32 x u32 -> (hi, lo): the int64 product wraps to the unsigned
    product's bit pattern, so mask after the (sign-extending) shift."""
    p = a * b
    return (p >> 32) & M32, p & M32


def _mul64_lo(a, b):
    hi, lo = _mul32(a[1], b[1])
    hi = (hi + a[1] * b[0] + a[0] * b[1]) & M32
    return hi, lo


def _mul128_fold(a, b):
    """(hi64 ^ lo64) of the full 128-bit product a * b."""
    ll = _mul32(a[1], b[1])
    lh = _mul32(a[1], b[0])
    hl = _mul32(a[0], b[1])
    hh = _mul32(a[0], b[0])
    mid = ll[0] + lh[1] + hl[1]          # < 3 * 2^32: no overflow
    lo64 = (mid & M32, ll[1])
    hi_lo = hh[1] + lh[0] + hl[0] + (mid >> 32)
    hi64 = ((hh[0] + (hi_lo >> 32)) & M32, hi_lo & M32)
    return _xor(hi64, lo64)


def _pair_rd64(g, off: int):
    lo = g(off) | (g(off + 1) << 8) | (g(off + 2) << 16) | (g(off + 3) << 24)
    hi = g(off + 4) | (g(off + 5) << 8) | (g(off + 6) << 16) | (g(off + 7) << 24)
    return hi, lo


def _pair_rd32(g, off: int):
    return g(off) | (g(off + 1) << 8) | (g(off + 2) << 16) | (g(off + 3) << 24)


def _full(like, v64):
    hi, lo = _const(v64)
    return torch.full_like(like, hi), torch.full_like(like, lo)


def _avalanche3(h):
    h = _xor(h, _shr(h, 37))
    h = _mul64_lo(h, _const(PRIME_MX1))
    return _xor(h, _shr(h, 32))


def _avalanche64(h):
    h = _xor(h, _shr(h, 33))
    h = _mul64_lo(h, _const(PRIME64_2))
    h = _xor(h, _shr(h, 29))
    h = _mul64_lo(h, _const(PRIME64_3))
    return _xor(h, _shr(h, 32))


def _rotl(h, r: int):
    a, b = _shl(h, r), _shr(h, 64 - r)
    return a[0] | b[0], a[1] | b[1]


def _pair_rrmxmx(h, length: int):
    h = _xor(h, _xor(_rotl(h, 49), _rotl(h, 24)))
    h = _mul64_lo(h, _const(PRIME_MX2))
    h = _xor(h, _add(_shr(h, 35), (0, length)))
    h = _mul64_lo(h, _const(PRIME_MX2))
    return _xor(h, _shr(h, 28))


def _pair_mix16(g, in_off: int, sec_off: int):
    lo = _xor(_pair_rd64(g, in_off), _const(_sec64(sec_off)))
    hi = _xor(_pair_rd64(g, in_off + 8), _const(_sec64(sec_off + 8)))
    return _mul128_fold(lo, hi)


# -- length paths --------------------------------------------------------------


def _len1to3(g, length: int):
    combined = (g(0) << 16) | (g(length >> 1) << 24) | g(length - 1) | (length << 8)
    keyed = (torch.zeros_like(combined), combined ^ (int(_sec32(0)) ^ int(_sec32(4))))
    return _avalanche64(keyed)


def _len4to8(g, length: int):
    keyed = _xor((_pair_rd32(g, 0), _pair_rd32(g, length - 4)), _const(_sec64(8) ^ _sec64(16)))
    return _pair_rrmxmx(keyed, length)


def _len9to16(g, length: int):
    lo = _xor(_pair_rd64(g, 0), _const(_sec64(24) ^ _sec64(32)))
    hi = _xor(_pair_rd64(g, length - 8), _const(_sec64(40) ^ _sec64(48)))
    acc = _add((0, length), (_bswap32(lo[1]), _bswap32(lo[0])))
    acc = _add(acc, hi)
    acc = _add(acc, _mul128_fold(lo, hi))
    return _avalanche3(acc)


def _bswap32(x):
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8) | ((x >> 8) & 0xFF00)
            | ((x >> 24) & 0xFF))


def _len17to128(g, length: int):
    acc = _full(g(0), (length * int(PRIME64_1)) & 0xFFFFFFFFFFFFFFFF)
    if length > 96:
        acc = _add(acc, _pair_mix16(g, 48, 96))
        acc = _add(acc, _pair_mix16(g, length - 64, 112))
    if length > 64:
        acc = _add(acc, _pair_mix16(g, 32, 64))
        acc = _add(acc, _pair_mix16(g, length - 48, 80))
    if length > 32:
        acc = _add(acc, _pair_mix16(g, 16, 32))
        acc = _add(acc, _pair_mix16(g, length - 32, 48))
    acc = _add(acc, _pair_mix16(g, 0, 0))
    acc = _add(acc, _pair_mix16(g, length - 16, 16))
    return _avalanche3(acc)


def _len129to240(g, length: int):
    acc = _full(g(0), (length * int(PRIME64_1)) & 0xFFFFFFFFFFFFFFFF)
    for i in range(8):
        acc = _add(acc, _pair_mix16(g, 16 * i, 16 * i))
    acc = _avalanche3(acc)
    for i in range(8, length // 16):
        acc = _add(acc, _pair_mix16(g, 16 * i, 16 * (i - 8) + 3))
    acc = _add(acc, _pair_mix16(g, length - 16, 136 - 17))
    return _avalanche3(acc)


def xxh3_64_cols(cols):
    """XXH3_64bits over byte columns: ``cols[j]`` holds byte j of every
    lane (integer tensors of one shape).  Returns ``(hi, lo)`` int64
    tensors of the lanes' shape, each in ``[0, 2^32)``.  Lengths 1..240."""
    length = len(cols)
    cache: dict[int, torch.Tensor] = {}

    def g(off: int):
        if off not in cache:
            cache[off] = cols[off].to(torch.int64)
        return cache[off]

    if 1 <= length <= 3:
        return _len1to3(g, length)
    if 4 <= length <= 8:
        return _len4to8(g, length)
    if 9 <= length <= 16:
        return _len9to16(g, length)
    if 17 <= length <= 128:
        return _len17to128(g, length)
    if 129 <= length <= 240:
        return _len129to240(g, length)
    raise NotImplementedError("device XXH3 supports lengths 1..240")


def check_bloom_size(size_bits: int) -> None:
    """The device Bloom-size contract of ``malva_tpu.ops.xxh3_jax``:
    n_gib * 2^33 bits with n_gib <= 8, or a power of two in [32, 2^32]."""
    if size_bits >= (1 << 33) and size_bits % (1 << 33) == 0:
        if size_bits >> 33 > 8:
            raise ValueError("device Bloom filters support at most 8 GiB per shard")
        return
    if size_bits & (size_bits - 1) or size_bits > (1 << 32) or size_bits < 32:
        raise ValueError(
            "device Bloom size must be N*2^33 (N<=8) or a power of two <= 2^32"
        )


def xxh3_mod_size(hi, lo, size_bits: int):
    """hash % size_bits -> (word index, bit), both int64 tensors."""
    check_bloom_size(size_bits)
    if size_bits >= (1 << 33):
        return xxh3_mod_gib(hi, lo, size_bits >> 33)
    idx = lo & (size_bits - 1)
    return idx >> 5, idx & 31


def xxh3_mod_gib(hi, lo, n_gib: int):
    """hash % (n_gib * 2^33) -> (word index, bit): the 64-bit modulo
    collapses to a 31-bit one, ``((hash >> 33) % n_gib) * 2^33 + (hash &
    (2^33 - 1))`` (xxh3_jax.py:333)."""
    if n_gib > 8:
        raise ValueError("device Bloom filters support at most 8 GiB per shard")
    qm = (hi >> 1) % n_gib
    word = (qm << 28) | ((hi & 1) << 27) | (lo >> 5)
    return word, lo & 31
