"""idle_in_program_pct (layer "device"; moves tiles_per_s): of the traced
sub-window's device-idle time (no kernel, copy or fill on the card, as in
``device_idle_pct``), the share in % during which the host was inside one
of the program's ``stain.*`` spans: the card waiting on the port's own
code rather than on the caller's loop. None where the program makes no
such span."""

from benchmark import program_spans


def read(rec):
    return program_spans.idle_in_program_pct(rec)
