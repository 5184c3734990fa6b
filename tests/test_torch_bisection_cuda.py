"""The staged kernels (K1, K2, K4, K6, K8, K9), whose percentile searches
take up to eight bisection rounds and the successor per cluster reduction
from leaf histograms, against their plain versions' sequential rounds, byte
for byte, at every cluster size G and at the benchmark's shapes: 256 tiles
of 256^2, 64 of 512^2, one image; and the reductions per tile each wrapper
reports.

Needs a CUDA device (marker ``cuda``; every test skips without one). The
card has no jax, so this file imports only torch, numpy and the port. On
the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_bisection_cuda.py
"""

import numpy as np
import pytest
import torch

from stainlib_tpu_torch.augmentation import functional as F
from stainlib_tpu_torch.kernels import fused_stain as fs
from stainlib_tpu_torch.kernels import macenko_fused as mf
from stainlib_tpu_torch.kernels import vahadane_fused as vf
from stainlib_tpu_torch.normalization import extractive
from synth import he_batch, he_patch

FAST = dict(fit_stride=2, n_bisect=10)  # the benchmark's Macenko knobs
VFAST = dict(fit_stride=2, num_iters=8, n_bisect=10)  # and Vahadane's
SHAPES = [(256, 256), (64, 512), (1, 256)]  # (tiles, side)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _tiles(batch, side, cuda):
    """H&E tiles; beyond one tile, one half white and one all white (an
    empty mask: collapsed brackets, only kBig above them)."""
    tiles = he_batch(batch, side, side, seed=2100 + side)
    if batch > 2:
        tiles[1, : side // 2] = 255
        tiles[2] = 255
    return torch.from_numpy(tiles).to(cuda)


def _target(cuda, method="macenko"):
    p = extractive.fit(torch.from_numpy(he_patch(256, 256, seed=90)),
                       method=method)
    return p.stain_matrix_target.to(cuda), p.max_c_target.to(cuda)


def _each_g(launch, want):
    """The kernel's output at every G equals the plain version's."""
    for g in mf.CLUSTER_SIZES:
        got = launch(g)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b), (g, float((a.float() - b.float())
                                                .abs().max()))


def _levels(n_sample, kernel, batch, cuda):
    return mf.hist_levels(mf.cluster_plan(n_sample, kernel, None, batch,
                                          mf.sm_count(cuda)))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,side", SHAPES)
def test_k1_bisection(cuda, batch, side):
    M, mc = _target(cuda)
    rgb = _tiles(batch, side, cuda)
    want = mf.macenko_normalize_ref(rgb, M, mc, **FAST)
    _each_g(lambda g: mf._launch(rgb, False, M, mc, g=g, **FAST), want)
    assert torch.equal(mf.macenko_normalize(rgb, M, mc, **FAST), want)
    assert mf.reductions_per_tile == 6  # was 12


@pytest.mark.cuda
@pytest.mark.parametrize("batch,side", SHAPES)
def test_k2_bisection(cuda, batch, side):
    M, mc = _target(cuda, "vahadane")
    rgb = _tiles(batch, side, cuda)
    want = vf.vahadane_normalize_ref(rgb, M, mc, **VFAST)
    _each_g(lambda g: vf._launch(rgb, False, M, mc, g=g, **VFAST), want)
    assert torch.equal(vf.vahadane_normalize(rgb, M, mc, **VFAST), want)
    n = np.prod(mf._sample_args(side * side, 2)[:2])
    assert vf.reductions_per_tile == mf.chain_length(
        "K2", mf.hist_levels(mf.cluster_plan(n, "K2")), 8, 10, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,side", SHAPES)
def test_k4_bisection(cuda, batch, side):
    planar = mf.to_planar(_tiles(batch, side, cuda)).contiguous()
    want = mf.macenko_fit_planar_ref(planar, n_bisect=10)
    _each_g(lambda g: mf._fit_launch(planar, n_bisect=10, g=g), want)
    mf.macenko_fit_planar(planar, n_bisect=10)
    assert mf.reductions_per_tile == 6


@pytest.mark.cuda
@pytest.mark.parametrize("batch,side", SHAPES)
def test_k6_bisection(cuda, batch, side):
    rgb = _tiles(batch, side, cuda)
    alpha, beta = F._stain_draws(torch.Generator().manual_seed(21), (batch,),
                                 0.2, 0.2, cuda)
    want = mf.macenko_augment_ref(rgb, alpha, beta, n_bisect=10)
    _each_g(lambda g: mf._aug_launch(rgb, False, alpha, beta, n_bisect=10,
                                     g=g), want)
    assert torch.equal(mf.macenko_augment(rgb, alpha, beta, n_bisect=10),
                       want)
    assert mf.reductions_per_tile == 3  # was 6


@pytest.mark.cuda
@pytest.mark.parametrize("batch,side", SHAPES)
def test_k8_bisection(cuda, batch, side):
    planar = mf.to_planar(_tiles(batch, side, cuda)).contiguous()
    want = vf._dict_plane_ref(planar, **VFAST)
    _each_g(lambda g: vf._dict_launch(planar, g=g, **VFAST), want)
    assert torch.equal(vf._dict_launch(planar, **VFAST), want)
    assert vf.reductions_per_tile == 11  # was 14


@pytest.mark.cuda
@pytest.mark.parametrize("batch,side", SHAPES)
def test_k9_bisection(cuda, batch, side):
    M, mc = _target(cuda)
    planar = mf.to_planar(_tiles(batch, side, cuda)).contiguous()
    src = vf._prior_where_nan(vf.vahadane_stain_matrix_planar_ref(planar))
    want = fs.fused_normalize_planar_ref(planar, src, M, mc)
    _each_g(lambda g: fs._launch(planar, True, src, M, mc, g=g), want)
    assert torch.equal(fs.fused_normalize_planar(planar, src, M, mc), want)
    assert fs.reductions_per_tile == 3  # was 7
