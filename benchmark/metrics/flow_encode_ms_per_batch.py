"""flow_encode_ms_per_batch (layer "model"; moves batch_ms_p95): the device
time of every activity launched inside the program's ``stain.flow.encode``
span (RGB -> HSD, the flow's forward, the GMM head and gamma's upsampling),
summed over the traced sub-window and divided by the spans in it: one per
batch. None where the program makes no such span."""

from benchmark import model_spans


def read(rec):
    return model_spans.span_device_ms(rec, "stain.flow.encode")
