"""The FASTQ layer on the driving thread: its `read` spans (parsing and
batching the job's input) and `write` spans (IUPAC resolution and
`FastqWriter.write`) over the window's input Mbp (seconds a Mbp). Nothing
without the program's spans."""

from benchmark import spans


def read(rec):
    return spans.s_per_mbp(rec, "read", "write")
