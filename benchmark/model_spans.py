"""The device time of the program's model spans in a traced run's records.

While a profiler records, the port's flow entry wraps each ``transform``
in ``stain.flow``, with ``stain.flow.encode`` (RGB -> HSD, the flow, the
GMM head) and ``stain.flow.transfer`` (the class transfer back to uint8)
nested in it (``stainlib_tpu_torch.normalization.flow``). They are
annotations of the profiler's own session, among ``trace.read``'s host
records. A program that makes no such span (an older commit) leaves these
readers nothing to read: each returns None.
"""

from __future__ import annotations

from benchmark import trace


def span_device_ms(rec, name: str):
    """The device time (ms) of every activity that a runtime call inside a
    host span ``name`` launched, per such span in the traced window (the
    matching of ``trace.entry_device_ms``); None where there is none."""
    tr = rec["trace"]
    if tr is None:
        return None
    w0, w1 = tr["window"]
    spans = [(h["ts"], h["dur"]) for h in tr["host"]
             if h["name"] == name and w0 <= h["ts"] <= w1]
    return trace.entry_device_ms(dict(entries=spans, device=tr["device"]))
