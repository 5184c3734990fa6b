"""The roofline arithmetic from shapes against the port's bound column
(PERF.md section 6, B=256 of 256x256 at the API's fast knobs)."""

from __future__ import annotations

import pytest

from benchmark import roofline

FS2 = dict(fit_stride=2, n_bisect=10)
N = 256 * 256


def test_macenko_is_bound_by_bytes():
    ms, by = roofline.bound_ms("macenko", 256, N, 0.6, FS2)
    assert by == "bytes"
    assert ms == pytest.approx(2 * 256 * N * 3 / 3.35e12 * 1e3)
    assert round(ms, 4) == 0.0300


def test_vahadane_is_bound_by_operations():
    """Half the pixels in tissue: per tile, over the 32,768-pixel sample,
    the estimate 3 + 0.5 * 71 operations a pixel, eight BCD passes 8 * 0.5
    * 56, the two concentration searches 48, and the apply 64 per pixel
    of the whole tile (128 per sample pixel)."""
    ms, by = roofline.bound_ms("vahadane", 256, N, 0.5,
                               dict(FS2, num_iters=8))
    assert by == "operations"
    ops = 256 * (N // 2) * (38.5 + 224 + 48 + 128)
    assert ms == pytest.approx(ops / 67e12 * 1e3)


def test_the_fixed_matrix_apply_reads_and_writes_once():
    b, ops = roofline.work("matrix", 256, N, 0.5, {})
    assert b == 2 * 256 * N * 3
    assert ops == 256 * N * (38 + 2 + 24)
    assert roofline.bound_ms("matrix", 256, N, 0.5, {})[1] == "bytes"


def test_less_tissue_less_work():
    knobs = dict(FS2, num_iters=8)
    full = roofline.work("vahadane", 64, N, 1.0, knobs)[1]
    half = roofline.work("vahadane", 64, N, 0.5, knobs)[1]
    assert half < full


def test_unknown_work_is_refused():
    with pytest.raises(ValueError):
        roofline.work("reinhard", 1, N, 1.0, {})
