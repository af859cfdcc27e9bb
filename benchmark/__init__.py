"""The benchmark of ratatosk_tpu_torch (README.md)."""
