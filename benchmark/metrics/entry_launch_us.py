"""entry_launch_us (layer "kernel wrappers"; moves tiles_per_s): the mean
duration in us of the program's ``stain.K<n>.launch`` spans that start in
the traced sub-window: a kernel entry's call into the kernel library (the
lookup, the stream, the ctypes call and the runtime's launch). Read under
the profiler, as ``entry_prep_us`` is. None where the program makes no
such span."""

from benchmark import program_spans


def read(rec):
    return program_spans.mean_phase_us(rec, "launch")
