"""device_idle_pct (layer "device"; moves tiles_per_s): the share, in %,
of the traced sub-window in which no kernel, copy or fill runs on the
card (the union of the profiler's device records)."""

from benchmark import trace


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    w0, w1 = tr["window"]
    busy = sum(b - a for a, b in trace.busy_intervals(tr["device"], w0, w1))
    return 100.0 * (1.0 - busy / (w1 - w0))
