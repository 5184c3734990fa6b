"""The program's own spans in a traced run's records.

While a profiler records, the port wraps each kernel entry in
``stain.K<n>``, with ``stain.K<n>.prep`` (everything before the kernel
call) and ``stain.K<n>.launch`` (the call into the kernel library) nested
in it, and its fit in ``stain.fit`` (``stainlib_tpu_torch.utils.
profiling``). They are annotations of the profiler's own session, so they
share the clock of the device records; ``trace.read`` keeps them among the
host records. A program that makes no such span (an older commit) leaves
these readers nothing to read: each returns None.
"""

from __future__ import annotations

import re

from benchmark import trace

_PHASE = re.compile(r"^stain\.K\d+\.(prep|launch)$")


def mean_phase_us(rec, phase: str):
    """The mean duration (us) of the ``stain.K<n>.<phase>`` spans that start
    in the traced window; None where there is none."""
    tr = rec["trace"]
    if tr is None:
        return None
    w0, w1 = tr["window"]
    durs = [h["dur"] for h in tr["host"] if w0 <= h["ts"] <= w1
            and (m := _PHASE.match(h["name"])) and m.group(1) == phase]
    return sum(durs) / len(durs) if durs else None


def idle_in_program_pct(rec):
    """Of the traced window's device-idle time (the window less the union
    of the device records), the share in % during which the host was
    inside a ``stain.*`` span; None where no such span meets the window."""
    tr = rec["trace"]
    if tr is None:
        return None
    w0, w1 = tr["window"]
    inside = trace.busy_intervals(
        [h for h in tr["host"] if h["name"].startswith("stain.")], w0, w1)
    if not inside:
        return None
    edges = [w0] + [x for ab in trace.busy_intervals(tr["device"], w0, w1)
                    for x in ab] + [w1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return 0.0
    return 100.0 * _overlap(idle, inside) / total


def _overlap(xs, ys):
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = xs[i]
        c, d = ys[j]
        total += max(0.0, min(b, d) - max(a, c))
        if b < d:
            i += 1
        else:
            j += 1
    return total
