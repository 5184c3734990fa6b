"""The frozen reference equals the port's plain CPU path on tiny tiles,
byte for byte and bit for bit."""

from __future__ import annotations

import pytest
import torch

from benchmark import tiles
from benchmark.reference import ops, planar
from benchmark.tests._tiny import TINY

torch.set_num_threads(2)


def _batch(n=4, side=128, seed=3):
    t = dict(TINY, batch=n, tile=side, pool_batches=1, slides_per_batch=2,
             shared_slides=False, centers=[0, 1, 2, 3, 4],
             background=[0.05, 0.6], vector_jitter=0.03, gain_jitter=0.15)
    return tiles.make_pool(t, seed, "cpu").batches[0]


@pytest.mark.parametrize("method", ["macenko", "vahadane"])
def test_fit_equals_the_port(method):
    from stainlib_tpu_torch.normalization import extractive

    target = _batch(1, 256, 11)[0]
    want = extractive.fit(target, method=method)
    M, mc = ops.fit(target, method=method)
    assert torch.equal(M, want.stain_matrix_target)
    assert torch.equal(mc, want.max_c_target)


@pytest.mark.parametrize("side", [128, 256])
def test_macenko_per_tile_equals_the_port(side):
    from stainlib_tpu_torch.kernels.macenko_fused import macenko_normalize

    x = _batch(3, side)
    M, mc = ops.fit(_batch(1, 128, 4)[0])
    kw = dict(fit_stride=2, n_bisect=10)
    assert torch.equal(planar.macenko_normalize(x, M, mc, **kw),
                       macenko_normalize(x, M, mc, **kw))


def test_vahadane_per_tile_equals_the_port():
    from stainlib_tpu_torch.kernels.vahadane_fused import vahadane_normalize

    x = _batch(3, 256)
    M, mc = ops.fit(_batch(1, 128, 4)[0], method="vahadane")
    kw = dict(fit_stride=2, num_iters=8, n_bisect=10)
    assert torch.equal(planar.vahadane_normalize(x, M, mc, **kw),
                       vahadane_normalize(x, M, mc, **kw))


def test_fixed_matrix_equals_the_port():
    from stainlib_tpu_torch.kernels.macenko_fused import normalize_with_matrix

    x = _batch(4, 128)
    src = ops.fit(x.reshape(-1, 128, 3))
    tgt = ops.fit(_batch(1, 128, 4)[0])
    assert torch.equal(planar.normalize_with_matrix(x, *src, *tgt),
                       normalize_with_matrix(x, *src, *tgt))


def test_the_control_rounds_below_float32():
    x = _batch(2, 128)
    M, mc = ops.fit(_batch(1, 128, 4)[0])
    a = planar.macenko_normalize(x, M, mc, fit_stride=2, n_bisect=10)
    b = planar.macenko_normalize(x, M, mc, fit_stride=2, n_bisect=10,
                                 low=torch.bfloat16)
    assert (a != b).float().mean() > 0.05
