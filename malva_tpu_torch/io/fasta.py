"""FASTA/FASTQ host readers (plain or gzip).

Mirrors the reference's use of kseq (reference: kseq.h, instantiated at
main.cpp:117; read loop main.cpp:285-295): record name = text after
'>'/'@' up to the first whitespace; sequence lines concatenated;
FASTA/FASTQ auto-detected per record.  Reference contigs are uppercased
and optionally have a leading "chr" stripped from their names.
"""

from __future__ import annotations

import gzip
from typing import Iterator

import numpy as np

from ..ops.seq import upper


def _open(path: str):
    f = open(path, "rb")
    if f.read(2) == b"\x1f\x8b":
        f.seek(0)
        return gzip.open(f, "rb")
    f.seek(0)
    return f


def iter_sequences(path: str) -> Iterator[tuple[str, bytes]]:
    """Yield (name, raw_sequence_bytes) per record, FASTA or FASTQ."""
    with _open(path) as f:
        name = None
        seq_parts: list[bytes] = []
        fastq_mode = False
        in_qual = False
        qual_len = 0
        seq_len = 0
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if not line and name is None:
                continue
            first = line[:1]
            if in_qual:
                qual_len += len(line)
                if qual_len >= seq_len:
                    in_qual = False
                continue
            if first == b"+" and fastq_mode:
                in_qual = True
                seq_len = sum(map(len, seq_parts))
                qual_len = 0
                continue
            if first in (b">", b"@"):
                if name is not None:
                    yield name, b"".join(seq_parts)
                name = line[1:].split()[0].decode() if len(line) > 1 else ""
                seq_parts = []
                fastq_mode = first == b"@"
                continue
            if name is not None:
                seq_parts.append(line)
        if name is not None:
            yield name, b"".join(seq_parts)


def load_reference(path: str, strip_chr: bool = False) -> dict[str, np.ndarray]:
    """Load all contigs uppercased into {name: (L,) uint8} (main.cpp:283-295)."""
    refs: dict[str, np.ndarray] = {}
    for name, seq in iter_sequences(path):
        if strip_chr and name.startswith("chr"):
            name = name[3:]
        refs[name] = upper(np.frombuffer(seq, dtype=np.uint8))
    return refs


def iter_read_batches(path: str, batch_bases: int = 1 << 26,
                      chunk_bytes: int = 1 << 25) -> Iterator[list[bytes]]:
    """Yield lists of read sequences totalling ~batch_bases each.

    Strict 4-line FASTQ (the dominant read format) takes a bulk path:
    chunks split once at newlines and sequence lines are every 4th
    element — no per-line Python.  Each chunk validates the 4-line phase
    ('@' headers, '+' separators); on ANY violation (multi-line/wrapped
    FASTQ, '@'-quirk FASTA) the kseq-style parser restarts from the top
    of the file and SKIPS the reads already yielded — safe because a
    read is only ever yielded after its '+' line validated, at which
    point both parsers agree on its sequence, so read index i means the
    same record to both.  kseq reference: kseq.h via main.cpp:285-295."""
    f = _open(path)
    head = f.read(1)
    if head != b"@":
        f.close()
        yield from _iter_read_batches_slow(path, batch_bases)
        return
    batch: list[bytes] = []
    total = 0
    carry = b"@"
    phase = 0  # next unconsumed line's position mod 4
    n_yielded = 0
    with f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            lines = (carry + chunk).split(b"\n")
            carry = lines.pop()
            if not lines:
                continue
            n = len(lines)
            ok = True
            for i in range((0 - phase) % 4, n, 4):  # header lines
                if not lines[i].startswith(b"@"):
                    ok = False
                    break
            if ok:
                for i in range((2 - phase) % 4, n, 4):  # '+' lines
                    if not lines[i].startswith(b"+"):
                        ok = False
                        break
            if not ok:
                f.close()
                yield from _iter_read_batches_slow(path, batch_bases,
                                                   skip=n_yielded)
                return
            seqs = lines[(1 - phase) % 4 :: 4]
            for s in seqs:
                batch.append(s.rstrip(b"\r"))
            total += sum(len(s) for s in seqs)
            phase = (phase + n) % 4
            if total >= batch_bases:
                held = None
                if phase == 2 and batch:
                    # phase 2 = the next expected line is this record's
                    # '+' separator, i.e. the seq line just appended is
                    # still UNVALIDATED (a wrapped record's continuation
                    # could follow instead): hold it back so every
                    # yielded read is '+'-validated and the skip-restart
                    # above stays exact.  (phase 1 = next line is a seq
                    # line, so the last appended read already passed its
                    # '+' check.)
                    held = batch.pop()
                if batch:
                    yield batch
                    n_yielded += len(batch)
                batch = [held] if held is not None else []
                total = len(held) if held is not None else 0
        if carry and phase == 1:  # trailing sequence line without newline
            batch.append(carry.rstrip(b"\r"))
    if batch:
        yield batch


def _iter_read_batches_slow(path: str, batch_bases: int,
                            skip: int = 0) -> Iterator[list[bytes]]:
    batch: list[bytes] = []
    total = 0
    for i, (_name, seq) in enumerate(iter_sequences(path)):
        if i < skip:
            continue
        batch.append(seq)
        total += len(seq)
        if total >= batch_bases:
            yield batch
            batch = []
            total = 0
    if batch:
        yield batch
