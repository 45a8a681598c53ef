"""Host VCF text reader/writer.

Replaces the reference's use of htslib (reference: main.cpp:261-272,
variant.hpp:126-211) with a pure-Python text parser that mirrors the
observable htslib behaviors the pipeline depends on:

* ``bcf_hdr_set_samples("-")`` selects all samples; a file path selects the
  listed sample names (main.cpp:264-266).
* GT arrays are laid out like htslib's ``bcf_get_genotypes``: per record a
  flat array of ``n_samples * max_ploidy`` encoded ints, where each allele
  is ``(allele+1) << 1 | phased`` (missing '.' encodes to 0, i.e. allele
  -1) and samples with fewer alleles than max_ploidy are padded with the
  ``VECTOR_END`` sentinel.  The phase bit of an allele reflects the
  separator *preceding* it ('|' vs '/').
* INFO Type=Float values are parsed to float32 (htslib stores float).
"""

from __future__ import annotations

import gzip
import re
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..utils.errors import InputError

VECTOR_END = -(1 << 31)  # mirrors bcf_int32_vector_end's role as padding

_GT_SPLIT = re.compile(r"([|/])")


class _SelList(list):
    """Selected-sample index list carrying a cached numpy view (building
    a fresh array per record costs more than the GT decode itself on
    30k-sample cohorts)."""

    @property
    def np(self):
        a = getattr(self, "_np", None)
        if a is None:
            a = self._np = np.asarray(list.__iter__(self) and list(self), dtype=np.int64)
        return a


def _open_text(path: str):
    f = open(path, "rb")
    if f.read(2) == b"\x1f\x8b":
        f.seek(0)
        return gzip.open(f, "rt")
    f.seek(0)
    return open(path, "rt")


def _open_binary(path: str):
    """Binary line stream (gz-transparent): the body reader keeps the
    sample region (columns 10+, ~10 KB/record on a 2,504-sample cohort)
    as bytes — no decode+re-encode round trip per record."""
    f = open(path, "rb", buffering=1 << 22)
    if f.read(2) == b"\x1f\x8b":
        f.seek(0)
        return gzip.open(f, "rb")
    f.seek(0)
    return f


# Cache of GT-string -> (encoded alleles tuple) since cohort VCFs repeat a
# small alphabet of GT strings millions of times.
_GT_CACHE: dict[str, tuple[int, ...]] = {}


def _encode_gt(gt: str) -> tuple[int, ...]:
    enc = _GT_CACHE.get(gt)
    if enc is not None:
        return enc
    parts = _GT_SPLIT.split(gt)  # [a0, sep, a1, sep, a2, ...]
    vals: list[int] = []
    if parts[0] == "" and len(parts) > 1:
        # leading separator ("|1"): its phase attaches to the first allele
        vals.append(_enc_allele(parts[2], 1 if parts[1] == "|" else 0))
        i = 3
    else:
        vals.append(_enc_allele(parts[0], 0))
        i = 1
    while i + 1 < len(parts):
        vals.append(_enc_allele(parts[i + 1], 1 if parts[i] == "|" else 0))
        i += 2
    enc = tuple(vals)
    if len(_GT_CACHE) < 1 << 20:
        _GT_CACHE[gt] = enc
    return enc


def _enc_allele(token: str, phased: int) -> int:
    if token == "." or token == "":
        return 0 | phased  # missing: bcf_gt_allele -> -1
    try:
        return ((int(token) + 1) << 1) | phased
    except ValueError as e:  # malformed user input, not an internal bug
        raise InputError(f"malformed GT allele {token!r}") from e


@dataclass
class VcfRecord:
    chrom: str
    pos0: int
    idx: str
    ref: str
    alts_raw: list[str]
    qual_raw: str
    filt: str
    info: str
    fmt: Optional[str]
    samples_raw: "str | bytes"  # unsplit tail of the line (columns 10+)
    n_samples: int
    _fields: Optional[list[str]] = None

    def _samples_bytes(self) -> bytes:
        s = self.samples_raw
        return s if isinstance(s, bytes) else s.encode("ascii", "replace")

    @property
    def sample_fields(self) -> list[str]:
        if self._fields is None:
            s = self.samples_raw
            if isinstance(s, bytes):
                self._fields = (
                    [f.decode("ascii", "replace") for f in s.split(b"\t")]
                    if s else []
                )
            else:
                self._fields = s.split("\t") if s else []
        return self._fields

    def info_floats(self, key: str) -> Optional[list[np.float32]]:
        """Float values of an INFO key, or None if absent
        (bcf_get_info_float).  Scans key occurrences at segment
        boundaries instead of splitting the whole INFO string — this
        runs once per record and INFO can be long; semantics match the
        old per-segment scan (first segment that IS the key or starts
        with ``key=`` wins)."""
        info = self.info
        lk = len(key)
        at = info.find(key)
        while at != -1:
            if at == 0 or info[at - 1] == ";":
                end = at + lk
                if end == len(info) or info[end] == ";":
                    return []
                if info[end] == "=":
                    seg_end = info.find(";", end)
                    seg = info[end + 1 : None if seg_end == -1 else seg_end]
                    out = []
                    for tok in seg.split(","):
                        try:
                            out.append(np.float32(tok))
                        except ValueError:
                            out.append(np.float32("nan"))
                    return out
            at = info.find(key, at + 1)
        return None

    def qual(self) -> np.float32:
        if self.qual_raw == "." or self.qual_raw == "":
            return np.float32("nan")
        try:
            return np.float32(self.qual_raw)
        except ValueError as e:
            raise InputError(f"malformed VCF QUAL {self.qual_raw!r}") from e

    def genotypes_arrays(self, selected) -> Optional[tuple[np.ndarray, int]]:
        """htslib-encoded GT matrix over the selected samples.

        Returns ((n_selected, max_ploidy) integer array with VECTOR_END
        padding, max_ploidy) or None when the record carries no GT data
        (mirrors bcf_get_genotypes(...) <= 0, variant.hpp:169-174).
        max_ploidy spans ALL samples (htslib parses before subsetting).

        Cohort fast path: when FORMAT starts with GT and every sample
        field matches the fixed-width single-digit pattern ("a|b" or a
        lone "a"), the whole region is decoded with numpy in one pass.
        """
        if self.fmt is None or len(selected) == 0:
            return None
        fmt_keys = self.fmt.split(":")
        try:
            gt_at = fmt_keys.index("GT")
        except ValueError:
            return None

        n = self.n_samples
        if n:
            # native single-pass parser first: ~4x the numpy pattern path
            # at 50 samples and ~2x at 2,504 (measured), same encoding
            from ..utils.native import parse_gt

            got = parse_gt(self._samples_bytes(), n, gt_at)
            if got is not None:
                enc, ploidy = got
                sel = selected.np if isinstance(selected, _SelList) else np.asarray(selected)
                return enc[sel], ploidy
        if gt_at == 0 and n:
            arr = np.frombuffer(self._samples_bytes(), dtype=np.uint8)
            L = arr.size
            if L == 4 * n - 1 and n and (arr[3::4] == 9).all():
                d1 = arr[0::4]
                sep = arr[1::4]
                d2 = arr[2::4]
                if (
                    ((sep == 124) | (sep == 47)).all()
                    and (((d1 >= 48) & (d1 <= 57)) | (d1 == 46)).all()
                    and (((d2 >= 48) & (d2 <= 57)) | (d2 == 46)).all()
                ):
                    enc1 = np.where(d1 == 46, 0, (d1.astype(np.int32) - 47) << 1)
                    enc2 = np.where(d2 == 46, 0, (d2.astype(np.int32) - 47) << 1) | (
                        sep == 124
                    )
                    enc = np.stack([enc1, enc2], axis=1)
                    sel = selected.np if isinstance(selected, _SelList) else np.asarray(selected)
                    return enc[sel], 2
            if L == 2 * n - 1 and n and (arr[1::2] == 9).all():
                d = arr[0::2]
                if (((d >= 48) & (d <= 57)) | (d == 46)).all():
                    enc = np.where(d == 46, 0, (d.astype(np.int32) - 47) << 1)
                    sel = selected.np if isinstance(selected, _SelList) else np.asarray(selected)
                    return enc[sel][:, None], 1
        out = self._genotypes_flat_slow(selected, gt_at)
        if out is None:
            return None
        flat, ploidy = out
        return np.asarray(flat, dtype=np.int32).reshape(len(selected), ploidy), ploidy

    def genotypes_flat(self, selected) -> Optional[tuple[list[int], int]]:
        """Back-compat flat list view of :meth:`genotypes_arrays`."""
        out = self.genotypes_arrays(selected)
        if out is None:
            return None
        enc, ploidy = out
        return enc.reshape(-1).tolist(), ploidy

    def _genotypes_flat_slow(self, selected, gt_at: int):
        # htslib parses the WHOLE record before subsetting, so max ploidy
        # spans all samples, not just the selected ones.  (slow path)
        all_encs: list[tuple[int, ...]] = []
        max_ploidy = 0
        for f in self.sample_fields:
            if gt_at == 0:
                end = f.find(":")
                gt = f if end < 0 else f[:end]
            else:
                gt = f.split(":")[gt_at]
            enc = _encode_gt(gt)
            all_encs.append(enc)
            if len(enc) > max_ploidy:
                max_ploidy = len(enc)
        flat: list[int] = []
        for si in selected:
            enc = all_encs[si]
            flat.extend(enc)
            flat.extend([VECTOR_END] * (max_ploidy - len(enc)))
        return flat, max_ploidy


class VcfReader:
    def __init__(self, path: str, samples: str = "-"):
        self.path = path
        self._fh = _open_binary(path)
        self.meta_lines: list[str] = []
        self.sample_names: list[str] = []
        for bline in self._fh:
            line = bline.rstrip(b"\n").decode("utf-8", "replace")
            if line.startswith("##"):
                self.meta_lines.append(line)
            elif line.startswith("#CHROM"):
                cols = line.split("\t")
                if len(cols) > 9:
                    self.sample_names = cols[9:]
                break
            else:
                raise InputError(f"malformed VCF header line: {line[:80]}")
        # sample subsetting semantics of bcf_hdr_set_samples
        if samples == "-":
            self.selected = list(range(len(self.sample_names)))
        else:
            with open(samples) as sf:
                wanted = [l.strip() for l in sf if l.strip()]
            name_to_i = {n: i for i, n in enumerate(self.sample_names)}
            missing = [w for w in wanted if w not in name_to_i]
            if missing:
                raise InputError(f"samples not in VCF: {missing[:5]}")
            self.selected = [name_to_i[w] for w in wanted]
        self.selected = _SelList(self.selected)

    def __iter__(self) -> Iterator[VcfRecord]:
        n = len(self.sample_names)
        for line in self._fh:
            line = line.rstrip(b"\n")
            if not line:
                continue
            yield parse_record(line, self.path, n)
        self._fh.close()

    def close(self) -> None:
        self._fh.close()


def parse_record(line: bytes, path: str, n_samples: int) -> VcfRecord:
    """One record from its line (no newline), as :class:`VcfReader` reads
    it; the native record scanner hands the lines it leaves over here."""
    cols = line.split(b"\t", 9)
    if len(cols) < 8:
        # htslib rejects records with fewer than the 8 fixed columns ("Few
        # fields"); a mid-record file truncation lands here
        raise InputError(
            f"{path}: malformed/truncated VCF record "
            f"({len(cols)} of 8 required columns): "
            f"{line[:60].decode('utf-8', 'replace')!r}"
        )
    head = [c.decode("utf-8", "replace") for c in cols[:9]]
    return VcfRecord(
        chrom=head[0],
        pos0=_parse_pos(head[1], path, line),
        idx=head[2],
        ref=head[3],
        alts_raw=head[4].split(",") if head[4] != "." else [],
        qual_raw=head[5],
        filt=head[6],
        info=head[7] if len(head) > 7 else ".",
        fmt=head[8] if len(head) > 8 else None,
        samples_raw=cols[9] if len(cols) > 9 else b"",
        n_samples=n_samples,
    )


def _parse_pos(tok: str, path: str, line: bytes) -> int:
    try:
        return int(tok) - 1
    except ValueError as e:
        raise InputError(
            f"{path}: malformed VCF POS {tok!r}: "
            f"{line[:60].decode('utf-8', 'replace')!r}"
        ) from e


def open_variant_reader(path: str, samples: str = "-"):
    """VcfReader or BcfReader by content sniffing — the htslib-equivalent
    transparent handling of text VCF / bgzip'd VCF / binary BCF
    (reference: bcf_open at main.cpp:261)."""
    from .bcf import BcfReader, is_bcf

    if is_bcf(path):
        return BcfReader(path, samples)
    return VcfReader(path, samples)


GT_HDR = '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">'
GQ_HDR = '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype Quality">'
COVS_HDR = '##INFO=<ID=COVS,Number=R,Type=Integer,Description="Allele coverages">'
GTS_HDR = '##INFO=<ID=GTS,Number=.,Type=String,Description="Genotypes Likelihood">'


def cleaned_header(meta_lines: list[str], verbose: bool) -> str:
    """The single-sample DONOR header (mirrors print_cleaned_header,
    main.cpp:190-219: existing lines kept in order, missing FORMAT/INFO
    definitions appended at the end, all samples replaced by DONOR)."""
    out = list(meta_lines)

    def has_id(kind: str, ident: str) -> bool:
        prefix = f"##{kind}=<ID={ident},"
        return any(l.startswith(prefix) for l in out)

    if not has_id("FORMAT", "GT"):
        out.append(GT_HDR)
    if not has_id("FORMAT", "GQ"):
        out.append(GQ_HDR)
    if verbose:
        if not has_id("INFO", "COVS"):
            out.append(COVS_HDR)
        if not has_id("INFO", "GTS"):
            out.append(GTS_HDR)
    out.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tDONOR")
    return "\n".join(out) + "\n"
