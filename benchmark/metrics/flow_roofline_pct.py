"""flow_roofline_pct (layer "model"; moves tiles_per_s): the least time one
H100 could take for one batch's encode, over the measured
flow_encode_ms_per_batch, in %.

The work is counted from shapes (``benchmark/flow_work.py``): the float32
operations of every convolution of the flow and the GMM head and of their
activations at 67 TFLOP/s, against the uint8 tiles and the weights at 3.35
TB/s; the operations rule. The card's power limit stands beside it in the
result line (``card``). None where the program makes no encode span."""

import sys

from benchmark import flow_work, model_spans


def read(rec):
    ms = model_spans.span_device_ms(rec, "stain.flow.encode")
    if ms is None:
        return None
    bound, by = flow_work.encode_bound_ms(rec["cfg"], rec["batch"],
                                          rec["side"])
    print(f"flow_roofline_pct: bound {bound!r} ms by {by}", file=sys.stderr)
    return 100.0 * bound / ms
