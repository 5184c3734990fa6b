"""entry_host_us (layer "kernel wrappers"; moves tiles_per_s): the mean
host time in us of the program's entry call (checks, per-tile tables,
cluster plan, staging buffers, the launch), the benchmark's own clock
around each call, without a synchronize: the time the host spends before
the call returns. Read in the traced run over every call of its window
before the profiled sub-window (the profiler adds its own cost to every
operation it records); over the profiled calls where the run is too short
to have such a part."""


def read(rec):
    if rec["trace"] is None or not rec["entry_host_us"]:
        return None
    return sum(rec["entry_host_us"]) / len(rec["entry_host_us"])
