"""flow_transfer_ms_per_batch (layer "model"; moves batch_ms_p95): the
device time of every activity launched inside the program's
``stain.flow.transfer`` span (the per-class transfer, HSD -> RGB and the
uint8 rounding), per batch, as ``flow_encode_ms_per_batch`` reads the
encode. None where the program makes no such span."""

from benchmark import model_spans


def read(rec):
    return model_spans.span_device_ms(rec, "stain.flow.transfer")
