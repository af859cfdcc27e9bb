"""The benchmark's plain reference: the port's plain route (NumPy on the
host, plain PyTorch for the beam search and the finish), frozen so that the
yardstick does not move with the program. It imports nothing of the program
and takes nothing the program made: it derives its own index from the reads
the benchmark hands it. PROVENANCE.md says where each file came from."""
