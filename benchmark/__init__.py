"""The benchmark of the port `stainlib_tpu_torch` (see README.md)."""
