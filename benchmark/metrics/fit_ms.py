"""fit_ms (layer "fit"; moves setup_s): host ms, synchronized, of the
set-up's fits through the program: the target's, and in a per-slide mix
the slide estimate on the mosaic."""


def read(rec):
    return rec["fit_ms"]
