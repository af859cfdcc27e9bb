"""The JAX package's own FASTQ digests, and the check that holds a run of the
port to them.

`data/jax_digests.json` is written by `scripts/jax_digests.py`, which runs
the JAX package (ratatosk_tpu) on the CPU on data made by the port's own
generators. Each entry records its route ("bench": Corrector, correct_file
and build_pass2_index as bench.py drives them; "cli": the `correct`
command), its data rule, its options or flags, the sha256 of its input
files (short reads as FASTA `>S<i>`, long reads as FASTQ), and the sha256
of pass 1's and the final FASTQ. A run of the port on the same data and
options must write the same bytes: `check` finds the entry of a run's
route, data rule and options and holds the run to it, its inputs first, so
that data that differ are reported as such and not as a fault of the port.

Nothing here imports JAX: the file is plain JSON.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Callable, Optional, Tuple

from ratatosk_tpu_torch import dna

PATH = Path(__file__).resolve().parent / "data" / "jax_digests.json"
SCRIPT = "scripts/jax_digests.py"
INPUTS = ("short.fa", "long.fq")
OUTPUTS = ("pass1", "final")


class DataMismatch(AssertionError):
    """The run's inputs are not the entry's: the comparison says nothing
    about the port."""


class Mismatch(AssertionError):
    """The run's FASTQ differ from the JAX package's on the same data and
    options: a fault of the port. `name` is the entry's."""

    def __init__(self, name: str, msg: str):
        super().__init__(msg)
        self.name = name


def load(path: Path = PATH) -> dict:
    """Every entry, by name."""
    with open(path) as f:
        return json.load(f)["entries"]


def find(route: str, data: dict, options, path: Path = PATH
         ) -> Optional[Tuple[str, dict]]:
    """(name, entry) of the entry with this route, data rule and options
    (a dict of CorrectOpt fields, or the command's flags as a list), or
    None."""
    want = json.loads(json.dumps(dict(route=route, data=data,
                                      options=options)))
    for name, e in load(path).items():
        if all(e[k] == v for k, v in want.items()):
            return name, e
    return None


def file_sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def short_fasta_sha256(sreads) -> str:
    """sha256 of the short reads written as FASTA (`>S<i>` and the bases on
    one line each), as the `correct` command's runs write them."""
    h = hashlib.sha256()
    for i, r in enumerate(sreads):
        h.update(f">S{i}\n{dna.decode(r)}\n".encode())
    return h.hexdigest()


def held(name: str, entry: dict, inputs: dict, fastq: dict) -> bool:
    """Whether the run's FASTQ sha256 (`fastq`: pass1, final) equal entry
    `name`'s. Raises DataMismatch first when its inputs' sha256 (`inputs`:
    short.fa, long.fq) differ from the entry's."""
    bad = [k for k in INPUTS if inputs[k] != entry["inputs_sha256"][k]]
    if bad:
        raise DataMismatch(
            f"{name}: the run's {', '.join(bad)} differ from the data "
            f"{SCRIPT} ran the JAX package on ({inputs} against "
            f"{entry['inputs_sha256']}): the data, not the port, differ")
    return all(fastq[k] == entry["fastq_sha256"][k] for k in OUTPUTS)


def check(route: str, data: dict, options, inputs: Callable[[], dict],
          fastq: dict, path: Path = PATH) -> Optional[str]:
    """Hold a run to the entry with its route, data rule and options (see
    `find`): returns the entry's name, or None where there is none. Raises
    DataMismatch when the run's inputs (`inputs()`, called only where there
    is an entry: short.fa, long.fq sha256) are not the entry's, and
    Mismatch when its FASTQ (`fastq`: pass1, final sha256) are not."""
    hit = find(route, data, options, path)
    if hit is None:
        return None
    name, entry = hit
    if not held(name, entry, inputs(), fastq):
        raise Mismatch(name, f"{name}: the run's FASTQ {fastq} differ from "
                       f"the JAX package's {entry['fastq_sha256']} on the "
                       "same data and options")
    return name
