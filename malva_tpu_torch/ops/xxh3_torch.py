"""XXH3_64bits over torch lanes, and the Bloom index it feeds.

:func:`xxh3_64_cols` is plain torch over byte columns, the counterpart of
``malva_tpu.ops.xxh3_jax`` and the plain version of the hashing inside
the call-step and ref-scan kernels (``csrc/xxh3.cuh`` holds the device
form, with native ``u64`` and ``__umul64hi``).  Every uint64 is carried
as a ``(hi, lo)`` pair of 32-bit values held in ``int64`` tensors (torch
has no add, shift or compare on ``uint32``/``uint64``), so every value
stays in ``[0, 2^32)``: ``>>`` on ``int64`` sign-extends, so every right
shift of a value that may have bit 63 set is masked; a 32x32 product can
overflow signed ``int64``, and its bit pattern is still the unsigned
product, so both halves are taken with masks.  Bit-exact with
``xxh3.xxh3_64`` (the host half, numpy only) at lengths 1..240
(parity-tested).  :func:`xxh3_mod_size` folds ``hash % size_bits`` into
a Bloom word and bit.
"""

from __future__ import annotations

import torch

from .xxh3 import (PRIME64_1, PRIME64_2, PRIME64_3, PRIME_MX1, PRIME_MX2, _sec32, _sec64,
                   check_bloom_size)

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
