"""The driving thread's `assemble` spans (`Corrector.assemble_batch`: each
read's output from its segments and corrected regions) over the window's
input Mbp (seconds a Mbp). Nothing without the program's spans."""

from benchmark import spans


def read(rec):
    return spans.s_per_mbp(rec, "assemble")
