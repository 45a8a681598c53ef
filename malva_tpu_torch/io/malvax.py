"""Import/export of the reference's on-disk index format (.malvax.zst).

The reference serializes its index as a zstd stream of
``context_bf >> s; bf >> s; ref_bf >> s`` (reference: main.cpp:406-412)
where a BF is ``[bool mode][size_t size][sdsl bit_vector][sdsl
int_vector<16>]`` (bloom_filter.hpp:127-136; rank is rebuilt on load) and
the KMAP is length-prefixed records (kmap.hpp:52-82).  sdsl int_vector
serialization = size-in-bits uint64 header + 64-bit-word-padded data
(fixed-width vectors carry no width byte).

This lets a user switching from `malva-geno` reuse an existing index, and
lets our index be consumed downstream.  zstd (de)compression uses the
zstandard package (streaming decompression: upstream writes with the
streaming API, so the frame has no content size).
"""

from __future__ import annotations

import struct

import numpy as np

from ..utils.errors import InputError

from ..index.bloom_filter import BF
from ..index.kmap import KMAP


def zstd_decompress(data: bytes) -> bytes:
    import zstandard

    # upstream writes with the streaming API (frame has no content size)
    return zstandard.ZstdDecompressor().stream_reader(data).read()


def zstd_compress(data: bytes, level: int = 5) -> bytes:
    import zstandard

    return zstandard.ZstdCompressor(level=level).compress(data)


class _Cursor:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise InputError("truncated .malvax stream")
        self.pos += n
        return b

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]


def _read_bf(cur: _Cursor) -> BF:
    mode = cur.take(1)[0] != 0
    size = cur.u64()
    bits = cur.u64()
    nwords64 = (bits + 63) // 64
    words64 = np.frombuffer(cur.take(nwords64 * 8), dtype="<u8")
    bf = BF(0)
    bf.size = size
    bf.words = words64.view("<u4").copy()  # little-endian u64 pairs == our u32 layout
    cbits = cur.u64()
    ncw = (cbits + 63) // 64
    cdata = np.frombuffer(cur.take(ncw * 8), dtype="<u8").view("<u2")[: cbits // 16]
    if mode:
        bf.switch_mode()
        if len(bf.counts) != len(cdata):
            raise InputError(
                f"counter length {len(cdata)} != popcount {len(bf.counts)} — corrupt index?"
            )
        bf.counts[:] = cdata.astype(np.uint32)
    return bf


def _write_bf(out: bytearray, bf: BF) -> None:
    out += bytes([1 if bf.mode else 0])
    out += struct.pack("<Q", bf.size)
    nwords64 = (bf.size + 63) // 64
    w = bf.words
    if w.shape[0] % 2:
        w = np.concatenate([w, np.zeros(1, np.uint32)])
    out += struct.pack("<Q", bf.size)  # bit_vector m_size (bits)
    out += w.astype("<u4").tobytes()[: nwords64 * 8]
    counts = bf.counts if bf.mode and bf.counts is not None else np.zeros(0, np.uint32)
    c16 = (counts & np.uint32(0xFFFF)).astype("<u2")
    bits = 16 * len(c16)
    out += struct.pack("<Q", bits)
    pad = (-len(c16)) % 4
    out += c16.tobytes() + b"\x00" * (pad * 2)


def read_malvax(path: str):
    """Read a reference-format index -> (bf, ref_bf, context_bf)."""
    raw = zstd_decompress(open(path, "rb").read())
    cur = _Cursor(raw)
    context_bf = _read_bf(cur)
    bf = _read_bf(cur)
    km = KMAP()
    n = cur.u64()
    for _ in range(n):
        klen = cur.u64()
        key = cur.take(klen)
        val = cur.i32()
        km.kmers[key] = val & 0xFFFFFFFF
    return bf, km, context_bf


def write_malvax(index, path: str) -> None:
    """Write the index in the reference's format (serialization order
    context_bf, bf, ref_bf — main.cpp:409-411)."""
    out = bytearray()
    _write_bf(out, index.context_bf)
    _write_bf(out, index.bf)
    out += struct.pack("<Q", len(index.ref_bf.kmers))
    for key, val in index.ref_bf.kmers.items():
        out += struct.pack("<Q", len(key))
        out += key
        out += struct.pack("<i", val - (1 << 32) if val >= (1 << 31) else val)
    open(path, "wb").write(zstd_compress(bytes(out)))
