"""Binary BCF 2.2 reader/writer (htslib's binary VCF container).

The reference consumes variants through htslib's ``bcf_read``/``bcf_unpack``
(reference: main.cpp:309-312), which transparently accepts text VCF, bgzip'd
VCF, and binary BCF.  This module supplies the binary leg: a reader exposing
the same record surface as :class:`malva_tpu.io.vcf.VcfRecord` (chrom/pos0/
idx/ref/alts_raw/qual/info_floats/genotypes_arrays), and a spec-conformant
writer (BGZF-blocked) used for fixtures and interop tests — no external BCF
tooling exists in this environment, so conformance is to the VCFv4.2 spec
section 6 (BCF2.2 encoding).

Decoding notes (spec + htslib behaviors the pipeline depends on):

* header dictionaries: FILTER/INFO/FORMAT share one string table ordered by
  first appearance (PASS is implicitly index 0); ``IDX=`` overrides; contigs
  get their own table;
* typed values: descriptor byte = size<<4 | type, size 15 -> following
  typed int holds the real size; types: 1/2/3 = int8/16/32, 5 = float32,
  7 = char;
* GT is stored exactly in htslib's encoding ((allele+1)<<1 | phased, 0 for
  '.'); per-width END-OF-VECTOR sentinels normalize to the int32 one
  (mirrors bcf_get_genotypes widening);
* QUAL missing = float word 0x7F800001.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from typing import Iterator, Optional

import numpy as np

from ..utils.errors import InputError

from .vcf import VECTOR_END, _SelList

BCF_MAGIC = b"BCF\x02\x02"
FLOAT_MISSING = 0x7F800001

_END8, _MISS8 = -127, -128          # int8 0x81, 0x80
_END16, _MISS16 = -32767, -32768
_END32 = VECTOR_END + 1             # 0x80000001
_MISS32 = VECTOR_END                # 0x80000000


def is_bcf(path: str) -> bool:
    """True when the (possibly BGZF-compressed) file is binary BCF."""
    try:
        with open(path, "rb") as f:
            head = f.read(2)
            f.seek(0)
            if head == b"\x1f\x8b":
                with gzip.open(f) as g:
                    return g.read(5) == BCF_MAGIC
            return head == BCF_MAGIC[:2] and f.read(5) == BCF_MAGIC
    except OSError:
        return False


class _Decoder:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def _typed_size(self, desc: int) -> tuple[int, int]:
        t = desc & 0x0F
        n = desc >> 4
        if n == 15:
            n = self.typed_int()
        return t, n

    def typed_int(self) -> int:
        desc = self.buf[self.off]
        self.off += 1
        t = desc & 0x0F
        if t == 1:
            v = struct.unpack_from("<b", self.buf, self.off)[0]
            self.off += 1
        elif t == 2:
            v = struct.unpack_from("<h", self.buf, self.off)[0]
            self.off += 2
        elif t == 3:
            v = struct.unpack_from("<i", self.buf, self.off)[0]
            self.off += 4
        else:
            raise InputError(f"typed int with type {t}")
        return v

    def typed_string(self) -> bytes:
        desc = self.buf[self.off]
        self.off += 1
        t, n = self._typed_size(desc)
        if t == 0:
            return b""
        if t != 7:
            raise InputError(f"typed string with type {t}")
        s = self.buf[self.off : self.off + n]
        self.off += n
        return s

    def typed_value(self):
        """Any typed value as (type, numpy array / bytes)."""
        desc = self.buf[self.off]
        self.off += 1
        t, n = self._typed_size(desc)
        if t == 0:
            return 0, np.zeros(0, np.int32)
        if t == 7:
            s = self.buf[self.off : self.off + n]
            self.off += n
            return 7, s
        dt = {1: np.int8, 2: np.int16, 3: np.int32, 5: np.float32}[t]
        nb = n * dt().itemsize
        a = np.frombuffer(self.buf, dt, count=n, offset=self.off)
        self.off += nb
        return t, a

    def skip_typed(self) -> None:
        self.typed_value()

    def vector_block(self, n_sample: int):
        """FORMAT value block: (type, per-sample count, (n_sample, c) array
        or bytes for char type)."""
        desc = self.buf[self.off]
        self.off += 1
        t, c = self._typed_size(desc)
        if t == 0 or c == 0:
            return t, 0, np.zeros((n_sample, 0), np.int32)
        if t == 7:
            nb = n_sample * c
            s = self.buf[self.off : self.off + nb]
            self.off += nb
            return t, c, s
        dt = {1: np.int8, 2: np.int16, 3: np.int32, 5: np.float32}[t]
        nb = n_sample * c * dt().itemsize
        a = np.frombuffer(self.buf, dt, count=n_sample * c, offset=self.off)
        self.off += nb
        return t, c, a.reshape(n_sample, c)


class BcfRecord:
    """Decoded BCF record with the VcfRecord query surface."""

    __slots__ = ("chrom", "pos0", "idx", "ref", "alts_raw", "filt", "info",
                 "_qual_word", "_info_vals", "_gt", "_n_sample")

    def __init__(self):
        self.filt = "PASS"
        self.info = "."

    def qual(self) -> np.float32:
        if self._qual_word == FLOAT_MISSING:
            return np.float32("nan")
        return np.frombuffer(struct.pack("<I", self._qual_word), np.float32)[0]

    def info_floats(self, key: str) -> Optional[list]:
        vals = self._info_vals.get(key)
        if vals is None:
            return None
        return [np.float32(v) for v in vals]

    def genotypes_arrays(self, selected) -> Optional[tuple[np.ndarray, int]]:
        if self._gt is None or len(selected) == 0:
            return None
        enc, ploidy = self._gt
        sel = selected.np if isinstance(selected, _SelList) else np.asarray(selected, np.int64)
        return enc[sel], ploidy


class BcfReader:
    """Iterates BcfRecord from a BCF 2.2 file (BGZF or raw)."""

    def __init__(self, path: str, samples: str = "-"):
        self.path = path
        f = open(path, "rb")
        if f.read(2) == b"\x1f\x8b":
            f.seek(0)
            self._fh = gzip.open(f, "rb")
        else:
            f.seek(0)
            self._fh = f
        magic = self._fh.read(5)
        if magic != BCF_MAGIC:
            raise InputError(f"not a BCF2.2 file: {path}")
        (l_text,) = struct.unpack("<I", self._fh.read(4))
        text = self._fh.read(l_text).rstrip(b"\x00").decode()

        self.meta_lines: list[str] = []
        self.sample_names: list[str] = []
        self.contigs: dict[int, str] = {}
        self.dict_strings: dict[int, str] = {}
        next_idx = 0
        next_contig = 0
        seen: set[str] = set()

        def add_dict(ident: str, idx: Optional[int]):
            nonlocal next_idx
            if ident in seen:
                return
            seen.add(ident)
            if idx is None:
                idx = next_idx
            self.dict_strings[idx] = ident
            next_idx = max(next_idx, idx + 1)

        add_dict("PASS", 0)
        for line in text.split("\n"):
            line = line.rstrip("\r")
            if not line:
                continue
            if line.startswith("##"):
                self.meta_lines.append(line)
                for kind in ("FILTER", "INFO", "FORMAT"):
                    pre = f"##{kind}=<ID="
                    if line.startswith(pre):
                        body = line[len(pre):]
                        ident = body.split(",", 1)[0].split(">", 1)[0]
                        idx = _idx_of(line)
                        add_dict(ident, idx)
                if line.startswith("##contig=<ID="):
                    ident = line[13:].split(",", 1)[0].split(">", 1)[0]
                    idx = _idx_of(line)
                    if idx is None:
                        idx = next_contig
                    self.contigs[idx] = ident
                    next_contig = max(next_contig, idx + 1)
            elif line.startswith("#CHROM"):
                cols = line.split("\t")
                if len(cols) > 9:
                    self.sample_names = cols[9:]

        if samples == "-":
            sel = list(range(len(self.sample_names)))
        else:
            with open(samples) as sf:
                wanted = [l.strip() for l in sf if l.strip()]
            name_to_i = {n: i for i, n in enumerate(self.sample_names)}
            missing = [w for w in wanted if w not in name_to_i]
            if missing:
                raise InputError(f"samples not in VCF: {missing[:5]}")
            sel = [name_to_i[w] for w in wanted]
        self.selected = _SelList(sel)
        self._gt_key = None
        for idx, s in self.dict_strings.items():
            if s == "GT":
                self._gt_key = idx

    def __iter__(self) -> Iterator[BcfRecord]:
        fh = self._fh
        while True:
            hdr = fh.read(8)
            if len(hdr) < 8:
                break
            l_shared, l_indiv = struct.unpack("<II", hdr)
            shared = fh.read(l_shared)
            indiv = fh.read(l_indiv)
            yield self._decode(shared, indiv)
        fh.close()

    def _decode(self, shared: bytes, indiv: bytes) -> BcfRecord:
        rec = BcfRecord()
        (rid, pos, _rlen, qual_word, n_ai, n_fs) = struct.unpack_from(
            "<iiiIII", shared, 0
        )
        rec.chrom = self.contigs.get(rid, str(rid))
        rec.pos0 = pos
        rec._qual_word = qual_word
        n_allele = n_ai >> 16
        n_info = n_ai & 0xFFFF
        n_fmt = n_fs >> 24
        n_sample = n_fs & 0xFFFFFF
        rec._n_sample = n_sample

        d = _Decoder(shared)
        d.off = 24
        ident = d.typed_string()
        rec.idx = ident.decode() if ident else "."
        alleles = [d.typed_string().decode() for _ in range(n_allele)]
        rec.ref = alleles[0] if alleles else ""
        rec.alts_raw = alleles[1:]
        d.skip_typed()  # FILTER indices (output always PASS, variant.hpp:91)
        info_vals: dict[str, np.ndarray] = {}
        for _ in range(n_info):
            key = d.typed_int()
            t, v = d.typed_value()
            name = self.dict_strings.get(key)
            if name is not None and t in (1, 2, 3, 5):
                info_vals[name] = v
        rec._info_vals = info_vals

        rec._gt = None
        di = _Decoder(indiv)
        for _ in range(n_fmt):
            key = di.typed_int()
            t, c, block = di.vector_block(n_sample)
            if key == self._gt_key and t in (1, 2, 3) and c > 0:
                enc = block.astype(np.int32, copy=False)
                end = {1: _END8, 2: _END16, 3: _END32}[t]
                miss = {1: _MISS8, 2: _MISS16, 3: _MISS32}[t]
                if t != 3:
                    enc = np.where(block == end, np.int32(_END32), enc)
                    enc = np.where(block == miss, np.int32(_MISS32), enc)
                # htslib's bcf_get_genotypes yields vector_end as
                # bcf_int32_vector_end; the text reader pads with
                # VECTOR_END — normalize to the text convention.
                enc = np.where(enc == np.int32(_END32), np.int32(VECTOR_END), enc)
                rec._gt = (np.ascontiguousarray(enc), c)
        return rec


def _idx_of(line: str) -> Optional[int]:
    at = line.find("IDX=")
    if at < 0:
        return None
    end = at + 4
    out = ""
    while end < len(line) and line[end].isdigit():
        out += line[end]
        end += 1
    return int(out) if out else None


# ---------------------------------------------------------------------------
# Writer (BGZF-blocked, spec-conformant): fixture generation and interop.

def _bgzf_block(payload: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    data = comp.compress(payload) + comp.flush()
    bsize = len(data) + 25 + 1  # fixed header(12) + XLEN extra(6) + crc/isize(8)
    header = (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
        + struct.pack("<H", 6)
        + b"BC" + struct.pack("<HH", 2, bsize - 1)
    )
    return header + data + struct.pack("<II", zlib.crc32(payload), len(payload) & 0xFFFFFFFF)


BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


class _BgzfWriter:
    def __init__(self, fh, block: int = 0xFF00):
        self.fh = fh
        self.block = block
        self.buf = bytearray()

    def write(self, b: bytes) -> None:
        self.buf += b
        while len(self.buf) >= self.block:
            self.fh.write(_bgzf_block(bytes(self.buf[: self.block])))
            del self.buf[: self.block]

    def close(self) -> None:
        if self.buf:
            self.fh.write(_bgzf_block(bytes(self.buf)))
        self.fh.write(BGZF_EOF)
        self.fh.close()


def _typed_int(v: int) -> bytes:
    if -120 <= v <= 127:
        return bytes([0x11]) + struct.pack("<b", v)
    if -32000 <= v <= 32767:
        return bytes([0x12]) + struct.pack("<h", v)
    return bytes([0x13]) + struct.pack("<i", v)


def _typed_header(t: int, n: int) -> bytes:
    if n < 15:
        return bytes([(n << 4) | t])
    return bytes([0xF0 | t]) + _typed_int(n)


def _typed_string(s: bytes) -> bytes:
    if not s:
        return b"\x07"
    return _typed_header(7, len(s)) + s


def write_bcf(path: str, meta_lines: list[str], sample_names: list[str],
              records, freq_key: Optional[str] = None) -> None:
    """Write records (any objects with chrom/pos0/idx/ref/alts_raw +
    info_floats + genotypes_arrays, e.g. VcfRecord) as BCF 2.2.

    Contigs and the FILTER/INFO/FORMAT dictionary are derived from
    meta_lines the same way the reader derives them, so a round trip is
    loss-free for the fields the genotyper consumes."""
    contig_ids: dict[str, int] = {}
    dict_ids: dict[str, int] = {"PASS": 0}
    metas = list(meta_lines)
    for line in metas:
        for kind in ("FILTER", "INFO", "FORMAT"):
            pre = f"##{kind}=<ID="
            if line.startswith(pre):
                ident = line[len(pre):].split(",", 1)[0].split(">", 1)[0]
                dict_ids.setdefault(ident, len(dict_ids))
        if line.startswith("##contig=<ID="):
            ident = line[13:].split(",", 1)[0].split(">", 1)[0]
            contig_ids.setdefault(ident, len(contig_ids))
    if "GT" not in dict_ids:
        metas.append('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
        dict_ids["GT"] = len(dict_ids)
    if freq_key is not None and freq_key not in dict_ids:
        metas.append(
            f'##INFO=<ID={freq_key},Number=A,Type=Float,Description="freq">'
        )
        dict_ids[freq_key] = len(dict_ids)

    recs = list(records)
    for r in recs:
        if r.chrom not in contig_ids:
            contig_ids[r.chrom] = len(contig_ids)
            metas.append(f"##contig=<ID={r.chrom}>")

    header = "\n".join(
        metas
        + ["#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
           + "\t".join(sample_names)]
    ) + "\n\x00"
    hbytes = header.encode()

    out = _BgzfWriter(open(path, "wb"))
    out.write(BCF_MAGIC + struct.pack("<I", len(hbytes)) + hbytes)

    all_idx = _SelList(range(len(sample_names)))
    for r in recs:
        freqs = r.info_floats(freq_key) if freq_key is not None else None
        gt = r.genotypes_arrays(all_idx)
        n_allele = 1 + len(r.alts_raw)
        n_info = 1 if freqs else 0
        n_fmt = 1 if gt is not None else 0

        shared = bytearray()
        qual = r.qual()
        qual_word = FLOAT_MISSING if np.isnan(qual) else struct.unpack(
            "<I", struct.pack("<f", float(qual)))[0]
        shared += struct.pack(
            "<iiiIII", contig_ids[r.chrom], r.pos0, len(r.ref),
            qual_word, (n_allele << 16) | n_info,
            (n_fmt << 24) | len(sample_names),
        )
        shared += _typed_string(b"" if r.idx in (".", "") else r.idx.encode())
        shared += _typed_string(r.ref.encode())
        for a in r.alts_raw:
            shared += _typed_string(a.encode())
        shared += b"\x11\x00"  # FILTER = [PASS]
        if freqs:
            shared += _typed_int(dict_ids[freq_key])
            shared += _typed_header(5, len(freqs))
            shared += np.asarray(freqs, np.float32).tobytes()

        indiv = bytearray()
        if gt is not None:
            enc, ploidy = gt
            enc = np.asarray(enc, np.int32)
            enc = np.where(enc == VECTOR_END, _END32, enc)
            indiv += _typed_int(dict_ids["GT"])
            vals = enc[enc != _END32]
            if int(vals.max(initial=0)) <= 127 and int(vals.min(initial=0)) >= -120:
                small = enc.astype(np.int8)
                small = np.where(enc == _END32, np.int8(_END8), small)
                indiv += _typed_header(1, ploidy) + small.tobytes()
            else:
                indiv += _typed_header(3, ploidy) + enc.tobytes()

        out.write(struct.pack("<II", len(shared), len(indiv)))
        out.write(bytes(shared) + bytes(indiv))
    out.close()
