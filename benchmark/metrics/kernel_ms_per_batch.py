"""kernel_ms_per_batch (layer "kernels"; moves batch_ms_p95): the device
time of every activity (kernels, copies, fills) that a runtime call inside
an entry call's span launched, summed over the traced sub-window and
divided by the entry calls in it. Taken from the profiler's device records
matched to their launches, not from kernel names, so it reads the same
work if the program splits or merges kernels."""

from benchmark import trace


def read(rec):
    return None if rec["trace"] is None else trace.entry_device_ms(
        rec["trace"])
