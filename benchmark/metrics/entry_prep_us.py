"""entry_prep_us (layer "kernel wrappers"; moves tiles_per_s): the mean
duration in us of the program's ``stain.K<n>.prep`` spans that start in
the traced sub-window: a kernel entry's host work before the kernel call
(the cluster plan, staging buffers, per-tile tables or pointer arguments,
the output's allocation). Read under the profiler, which adds its own cost
to every operation it records, so it compares commits under the same
conditions; ``entry_host_us`` is the entry's time away from it. None where
the program makes no such span."""

from benchmark import program_spans


def read(rec):
    return program_spans.mean_phase_us(rec, "prep")
