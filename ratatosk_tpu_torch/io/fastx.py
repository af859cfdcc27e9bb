"""FASTA/FASTQ streaming IO (plain or gzip), paired inputs, trim/split writer.

Host-side data path mirroring the reference's FileParser + output subsystem
(SURVEY.md §2.2(15), Ratatosk.cpp:510-616): Phred33 linear-scale qualities,
`-t Q` trim/split into `name/i` sub-reads (length >= k, all quals >= Q,
README.md:119-121), and deterministic output ordering (records are written in
input order; the reference reorders ticketed blocks, Ratatosk.cpp:919-999 —
our writer is sequential per process, with multi-host merge at the CLI layer).

A C-accelerated parser (ctypes) can plug in behind the same generator API.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ratatosk_tpu_torch import dna


@dataclasses.dataclass
class Record:
    name: str
    codes: np.ndarray             # uint8 base codes (0-3, 4=N)
    qual: Optional[np.ndarray]    # uint8 Phred33 chars, or None (FASTA)

    @property
    def seq(self) -> str:
        return dna.decode(self.codes)


def _open(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def sniff_format(path: str) -> str:
    """'fasta' | 'fastq' by first byte (reference Common.cpp:412 getFileFormat)."""
    with _open(path) as f:
        c = f.read(1)
    if c == ">":
        return "fasta"
    if c == "@":
        return "fastq"
    raise ValueError(f"{path}: not FASTA/FASTQ (starts with {c!r})")


def read_fastx(path: str, prefer_native: bool = True) -> Iterator[Record]:
    if prefer_native:
        from ratatosk_tpu_torch.io import native
        if native.available():
            yield from native.read_records(path)
            return
    fmt = sniff_format(path)
    with _open(path) as f:
        if fmt == "fasta":
            name, chunks = None, []
            for line in f:
                line = line.rstrip("\n")
                if line.startswith(">"):
                    if name is not None:
                        yield Record(name, dna.encode("".join(chunks)), None)
                    name = line[1:].split()[0]
                    chunks = []
                else:
                    chunks.append(line)
            if name is not None:
                yield Record(name, dna.encode("".join(chunks)), None)
        else:
            while True:
                hdr = f.readline()
                if not hdr:
                    break
                seq = f.readline().rstrip("\n")
                f.readline()  # '+'
                qual = f.readline().rstrip("\n")
                yield Record(hdr.rstrip("\n")[1:].split()[0], dna.encode(seq),
                             np.frombuffer(qual.encode("ascii"), dtype=np.uint8).copy())


def read_many(paths: Sequence[str]) -> Iterator[Record]:
    for p in paths:
        yield from read_fastx(p)


def read_paired(path1: str, path2: str) -> Iterator[Tuple[Record, Record]]:
    """Zip two mate files (-1/-2 inputs); mates share one color id downstream."""
    it1, it2 = read_fastx(path1), read_fastx(path2)
    for r1, r2 in zip(it1, it2):
        yield r1, r2


class FastqWriter:
    """Sequential FASTQ writer with optional gzip and trim/split.

    trim_qual > 0 splits each read into maximal sub-reads whose bases all have
    quality >= trim_qual and length >= min_len, named `name/i`
    (Ratatosk.cpp:530-559).
    """

    def __init__(self, path: str, trim_qual: int = 0, min_len: int = 63,
                 write_qual: bool = True):
        self.path = path
        self.trim_qual = trim_qual
        self.min_len = min_len
        self.write_qual = write_qual
        self._f = _open(path, "wt")

    def write(self, name: str, codes: np.ndarray, qual: Optional[np.ndarray],
              iupac: Optional[np.ndarray] = None):
        if qual is None:
            qual = np.full(len(codes), 33 + 40, dtype=np.uint8)
        if self.trim_qual <= 0:
            self._emit(name, codes, qual, iupac)
            return
        ok = qual >= (33 + self.trim_qual)
        i, sub = 0, 1     # sub-read numbering starts at /1 (Ratatosk.cpp:528)
        n = len(codes)
        while i < n:
            if not ok[i]:
                i += 1
                continue
            j = i
            while j < n and ok[j]:
                j += 1
            if j - i >= self.min_len:
                self._emit(f"{name}/{sub}", codes[i:j], qual[i:j],
                           None if iupac is None else iupac[i:j])
                sub += 1
            i = j

    def _emit(self, name: str, codes: np.ndarray, qual: np.ndarray,
              iupac: Optional[np.ndarray] = None):
        seq = dna.decode(codes)
        if iupac is not None and iupac.any():
            chars = np.frombuffer(seq.encode(), np.uint8).copy()
            amb = iupac != 0
            chars[amb] = dna.IUPAC_CHARS[iupac[amb] & 15]
            seq = chars.tobytes().decode()
        self._f.write(f"@{name}\n{seq}\n+\n")
        if self.write_qual:
            self._f.write(qual.tobytes().decode("ascii") + "\n")
        else:
            self._f.write("I" * len(codes) + "\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
