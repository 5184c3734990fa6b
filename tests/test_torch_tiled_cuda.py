"""The hand-written CUDA kernels of the tiled route (K3 fixed-matrix apply,
K4 Macenko fit) and the eigenplane kernel (K10) against their plain
PyTorch versions, and the tiled drop-in route.

Needs a CUDA device (marker ``cuda``; every test skips without one). The
card has no jax, so this file imports only torch, numpy and the port. On
the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_tiled_cuda.py

Tolerances: K3 at most 1 uint8 step on under 0.1% of the bytes; K4 rows
atol 1e-5 and maxC rtol 1e-5; K10 atol 1e-6. The kernels and the plain
versions share the OD tables and sum the moments in double / float64.
"""

import numpy as np
import pytest
import torch

import stainlib_tpu_torch as st
from stainlib_tpu_torch.kernels import fused_stain as fs
from stainlib_tpu_torch.kernels import macenko_fused as mf
from stainlib_tpu_torch.normalization import extractive
from synth import he_batch, he_patch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _params(device):
    p = extractive.fit(torch.from_numpy(he_patch(256, 256, seed=90)))
    return p.stain_matrix_target.to(device), p.max_c_target.to(device)


def _u8_close(got, want):
    d = (got.int() - want.int()).abs()
    assert d.max() <= 1 and (d > 0).float().mean() < 1e-3, (
        int(d.max()), float((d > 0).float().mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("side,batch", [(256, 8), (512, 2)])
def test_k4_k10_k3_match_plain_versions(cuda, side, batch):
    M, mc = _params(cuda)
    rgb = torch.from_numpy(he_batch(batch, side, side, seed=97)).to(cuda)
    planar = fs.to_planar(rgb).contiguous()
    before = (mf.fit_launches, mf.eigenplane_launches, mf.matrix_launches)
    Mk, mck = mf.macenko_fit_planar(planar)
    Mp, mcp = mf.macenko_fit_planar_ref(planar)
    assert float((Mk - Mp).abs().max()) <= 1e-5
    assert float(((mck - mcp).abs() / mcp.abs()).max()) <= 1e-5
    V = mf.eigenplane(planar)
    assert float((V - mf.eigenplane_ref(planar)).abs().max()) <= 1e-6
    got = mf.normalize_with_matrix_planar(planar, Mp, mcp, M, mc)
    _u8_close(got, mf.normalize_with_matrix_planar_ref(planar, Mp, mcp, M,
                                                       mc))
    assert torch.equal(mf.normalize_with_matrix(rgb, Mp, mcp, M, mc),
                       fs.from_planar(got, side, side))
    assert (mf.fit_launches, mf.eigenplane_launches,
            mf.matrix_launches) == (before[0] + 1, before[1] + 1,
                                    before[2] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1024, 1024), (2, 600, 700),
                                   (1, 2048, 2048)])
def test_k3_whole_field_matches_plain_and_blocks(cuda, shape):
    """K3 on a whole field of any size; the blockified route gives the
    same bytes."""
    M, mc = _params(cuda)
    rgb = torch.from_numpy(he_batch(*shape, seed=98)).to(cuda)
    Ms, mcs = extractive.estimate_source(rgb[:, ::4, ::4])
    got = mf.normalize_with_matrix(rgb, Ms, mcs, M, mc)
    _u8_close(got, mf.normalize_with_matrix_ref(rgb, Ms, mcs, M, mc))
    p = extractive.ExtractiveParams(M, mc)
    whole = extractive.transform_tiled(p, rgb, est_stride=4)
    blocks = extractive.transform_tiled(p, rgb, est_stride=4, block=512)
    assert torch.equal(whole, blocks)


@pytest.mark.cuda
def test_kernels_deterministic_and_per_tile(cuda):
    """Identical bytes on a second run; a tile's result does not depend on
    its batch neighbours."""
    M, mc = _params(cuda)
    rgb = torch.from_numpy(he_batch(8, 256, 256, seed=99)).to(cuda)
    planar = fs.to_planar(rgb).contiguous()
    Mk, mck = mf.macenko_fit_planar(planar)
    assert torch.equal(mf.macenko_fit_planar(planar)[0], Mk)
    one = mf.macenko_fit_planar(planar[3:4].contiguous())
    assert torch.equal(one[0][0], Mk[3]) and torch.equal(one[1][0], mck[3])
    V = mf.eigenplane(planar)
    assert torch.equal(mf.eigenplane(planar), V)
    assert torch.equal(mf.eigenplane(planar[3:4].contiguous())[0], V[3])
    out = mf.normalize_with_matrix(rgb, Mk, mck, M, mc)
    assert torch.equal(mf.normalize_with_matrix(rgb, Mk, mck, M, mc), out)
    assert torch.equal(mf.normalize_with_matrix(
        rgb[3:4].contiguous(), Mk[3], mck[3], M, mc)[0], out[3])


@pytest.mark.cuda
def test_dropin_routes_large_fields_through_k4_and_k3(cuda):
    norm = st.ExtractiveStainNormalizer("macenko", device=cuda)
    norm.fit(he_patch(256, 256, seed=90))
    img = he_batch(1, 1024, 1024, seed=100)[0]
    before = (mf.fit_launches, mf.matrix_launches, mf.launches)
    out = norm.transform(img)
    assert (mf.fit_launches, mf.matrix_launches, mf.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    assert out.dtype == np.uint8 and out.shape == img.shape
    want = extractive.transform(norm._params,
                                torch.from_numpy(img).to(cuda)).cpu().numpy()
    d = np.abs(out.astype(int) - want.astype(int))
    assert d.max() <= 3 and (d > 1).mean() < 1e-2


@pytest.mark.cuda
def test_wrappers_reject_strided_input(cuda):
    M, mc = _params(cuda)
    rgb = torch.from_numpy(he_batch(2, 256, 256, seed=99)).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        mf.normalize_with_matrix(rgb.transpose(1, 2), M, mc, M, mc)
    with pytest.raises(ValueError, match="contiguous"):
        mf.macenko_fit_planar(fs.to_planar(rgb))
    with pytest.raises(ValueError, match="contiguous"):
        mf.eigenplane(fs.to_planar(rgb))


def _k4_sizes():
    """Subsample sizes of the tiled route (8192..512^2 pixels): the
    smallest, one that is no multiple of 16 x 512, a 256^2 one, the
    largest; and a 1024^2 tile, which the public wrapper takes and the
    cluster stages in device memory."""
    return [8192, 9216, 256 * 256, 512 * 512, 1024 * 1024]


def _k4_exact(planar, g=None):
    Mk, mck = mf._fit_launch(planar, g=g)
    Mp, mcp = mf.macenko_fit_planar_ref(planar)
    for got, want in ((Mk, Mp), (mck, mcp)):
        assert torch.allclose(got, want, rtol=0, atol=0, equal_nan=True), (
            float((got - want).abs().nan_to_num(0.0).max()))
    return Mk, mck


@pytest.mark.cuda
@pytest.mark.parametrize("n_pix", _k4_sizes())
def test_k4_cluster_equals_plain_at_every_cluster_size(cuda, n_pix):
    """K4's rows and maxC equal the plain version's exactly at each G the
    plan can take (forced through ``cluster_plan``'s ``g``), whether the
    slices are staged in shared or in device memory; two runs agree."""
    rgb = torch.from_numpy(he_batch(3, n_pix // 128, 128, seed=101)).to(cuda)
    planar = fs.to_planar(rgb).contiguous()
    assert mf.cluster_plan(n_pix, "K4").g == 16
    for g in mf.CLUSTER_SIZES:
        _k4_exact(planar, g)
    before = mf.fit_launches
    Mk, mck = _k4_exact(planar)
    assert mf.fit_launches == before + 1
    again = mf.macenko_fit_planar(planar)
    assert torch.equal(again[0], Mk) and torch.equal(again[1], mck)


@pytest.mark.cuda
def test_k4_cluster_white_tile_and_single_image(cuda):
    """An all-white tile (empty mask) and one image alone: exactly the
    plain version."""
    tiles = he_batch(3, 128, 128, seed=102)
    tiles[1] = 255
    planar = fs.to_planar(torch.from_numpy(tiles).to(cuda)).contiguous()
    Mk, mck = _k4_exact(planar)
    one = _k4_exact(planar[2:3].contiguous())
    assert torch.equal(one[0][0], Mk[2]) and torch.equal(one[1][0], mck[2])
