"""kernel_roofline_pct (layer "kernels"; moves tiles_per_s): the least
time one H100 could take for one batch's normalize work, over the measured
kernel_ms_per_batch, in %.

The work is counted from shapes (``benchmark/roofline.py``): 3 bytes per
pixel read once and 3 written once at 3.35 TB/s, and the float32
operations of the configuration's algorithm at its knobs (for the
per-tile estimate, scaled by the share of the batch's pixels in the tissue
mask) at 67 TFLOP/s. The larger bound rules: the bytes for the Macenko
fit + transform and the fixed-matrix apply, the operations for Vahadane's
BCD steps; the run's standard error names which. The card's power limit
stands beside it in the result line (``card``)."""

import sys

from benchmark import roofline, trace


def read(rec):
    if rec["trace"] is None:
        return None
    ms = trace.entry_device_ms(rec["trace"])
    if ms is None:
        return None
    bound, by = roofline.bound_ms(rec["work"], rec["batch"],
                                  rec["side"] * rec["side"],
                                  rec["tissue_share"], rec["cfg"])
    print(f"kernel_roofline_pct: bound {bound!r} ms by {by} "
          f"({rec['work']}, tissue share {rec['tissue_share']!r})",
          file=sys.stderr)
    return 100.0 * bound / ms
