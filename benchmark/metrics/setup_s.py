"""setup_s (end to end): from the start of the benchmark's process to the
first timed batch, host clock: imports, the CUDA context, loading (the
first run in a checkout: building) the kernel library, the pool made on
the card, the fits and the warm-up of the cell's shapes."""


def read(rec):
    return rec["setup_s"]
