"""The least time one H100 could take for a batch's normalize work: bytes
and float32 operations counted from shapes, against the card's published
peaks.

The arithmetic is that of the bound column of the port's kernel table
(``PERF.md`` section 6; ``chip_smoke.py``'s ``work`` and ``bound``): each
input byte read once and each output byte written once, and the
operations each algorithm needs per pixel visit, counted from its
expressions with each intermediate computed once. Where the work depends
on the data (the estimate visits tissue pixels only), the share of the
batch's pixels in the tissue mask scales it. Whatever implements a
kernel, the bound stays: it is the work, not the code.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's device memory rate
F32_OPS_PER_S = 67e12  # its float32 rate outside the tensor cores

# float32 operations per pixel visit: the tissue mask (two adds, a
# compare), the masked moments (3 sums, 6 products, 6 sums), the
# pseudo-angle, the min/max pass, one bisection round of one search (a
# compare, an add), one successor recovery (a compare, a min, an add), the
# exact K=2 lasso, the augment gate, the three-channel reconstruction, one
# BCD pass (a lasso, 9 products, 9 sums) and Reinhard's per-pixel LAB round
# trip with its sums.
OPS = dict(mask=3, moments=15, angle=16, extreme=2, round=2, succ=3,
           lasso=38, gate=5, recon=24, bcd=56, reinhard=111)


def _est_ops(n, it_angle, tissue):
    """The Macenko estimate over n sample pixels, a share ``tissue`` of
    them in the mask."""
    return n * (OPS["mask"] + tissue * (
        OPS["moments"] + OPS["angle"] + OPS["extreme"]
        + 2 * it_angle * OPS["round"] + 2 * OPS["succ"]))


def _conc_ops(n, it_conc):
    """The two 99th-percentile concentration searches over n pixels."""
    return n * (OPS["extreme"] + 2 * it_conc * OPS["round"] + 2 * OPS["succ"])


def work(kernel: str, b: int, n: int, tissue: float, knobs: dict):
    """(bytes, float32 operations) of one call on ``b`` images of ``n``
    pixels. ``kernel`` names the work: ``"macenko"`` (fit and transform per
    tile), ``"vahadane"`` (the same with BCD dictionary steps) or
    ``"matrix"`` (the fixed-matrix apply); ``knobs`` are the call's
    ``fit_stride``, ``n_bisect`` and ``num_iters``."""
    io = 2 * b * n * 3  # uint8 in and out
    s = n // knobs.get("fit_stride", 1)  # the estimation sample
    nb = knobs.get("n_bisect", 14)
    it_angle = max(nb - 4, 8)
    apply = OPS["lasso"] + 2 + OPS["recon"]
    if kernel == "macenko":
        ops = _est_ops(s, it_angle, tissue) + n * apply + _conc_ops(s, nb)
    elif kernel == "vahadane":
        ops = (_est_ops(s, it_angle, tissue)
               + knobs["num_iters"] * tissue * s * OPS["bcd"] + n * apply
               + _conc_ops(s, nb))
    elif kernel == "matrix":
        ops = n * apply
    else:
        raise ValueError(f"no work model for {kernel!r}")
    return io, ops * b


def bound_ms(kernel: str, b: int, n: int, tissue: float, knobs: dict):
    """(the least time in ms, "bytes" or "operations": which bound rules)."""
    n_bytes, ops = work(kernel, b, n, tissue, knobs)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
