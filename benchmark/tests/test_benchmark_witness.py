"""The witness from outside the port (witness.py): the JAX package's own
digests of bench.py's data and of its pass-1 FASTQ, at seed 1234."""

from __future__ import annotations

import pytest
import torch

from benchmark import witness as W


@pytest.mark.parametrize("entry", sorted(W.JAX))
def test_data_is_the_jax_packages(entry):
    """gen.py's draw at seed 1234 is the input the JAX package ran on."""
    sreads, lreads = W.data(entry)
    got = W.inputs_sha256(sreads, lreads)
    assert got == {k: W.JAX[entry][k] for k in got}


def test_reference_writes_the_jax_packages_pass1():
    """The reference, on its own index, corrects bench.py's smoke-size reads
    to the JAX package's pass-1 FASTQ byte for byte."""
    sreads, lreads = W.data("bench_smoke")
    got = W.reference_pass1_sha256(sreads, lreads, torch.device("cpu"))
    assert got == W.JAX["bench_smoke"]["pass1"]
