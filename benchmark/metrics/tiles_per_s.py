"""tiles_per_s (end to end): every tile whose batch completed inside the
window, over the window's seconds (host clock; the window spans the run's
whole ``--seconds``)."""


def read(rec):
    return rec["completed"] * rec["batch"] / rec["window_s"]
