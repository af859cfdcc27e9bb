"""The benchmark's own FASTQ: it writes the long reads it hands the program
and reads back what the program wrote, with no code of the program."""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)


def decode(codes: np.ndarray) -> str:
    """Base codes 0-3 (4 and above: N) as a string."""
    return BASES[np.minimum(codes, 4)].tobytes().decode("ascii")


def write_fastq(path, records) -> None:
    """(name, codes) records, every quality '!' (no quality given), as the
    sequencer's reads in bench.py's long-read file."""
    with open(path, "w") as f:
        for name, codes in records:
            f.write(f"@{name}\n{decode(codes)}\n+\n{'!' * len(codes)}\n")


def read_fastq(path):
    """[(name, sequence, quality)] of a four-line FASTQ."""
    out = []
    with open(path) as f:
        while True:
            hdr = f.readline()
            if not hdr:
                return out
            seq = f.readline().rstrip("\n")
            f.readline()
            qual = f.readline().rstrip("\n")
            out.append((hdr[1:].split()[0], seq, qual))
