"""The hand-written CUDA kernels of the tiled route (K3 fixed-matrix apply,
K4 Macenko fit) and the eigenplane kernel (K10) against their plain
PyTorch versions, and the tiled drop-in route.

Needs a CUDA device (marker ``cuda``; every test skips without one). The
card has no jax, so this file imports only torch, numpy and the port. On
the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_tiled_cuda.py

Tolerances: K3 at most 1 uint8 step on under 0.1% of the bytes; K4 rows
atol 1e-5 and maxC rtol 1e-5; K10 atol 1e-6. The kernels and the plain
versions share the OD tables and sum the moments in double / float64; K10
runs its eigen-solve in the kernel, op for op as torch runs the plain
version's glue on the card.
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


def _k3_bytes(x, planar, *args):
    fn, ref = ((mf.normalize_with_matrix_planar,
                mf.normalize_with_matrix_planar_ref) if planar
               else (mf.normalize_with_matrix, mf.normalize_with_matrix_ref))
    before = mf.matrix_launches
    got = fn(x, *args)
    assert mf.matrix_launches == before + 1
    _u8_close(got, ref(x, *args))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("shared", [False, True])
def test_k3_shared_and_per_tile_values_in_both_layouts(cuda, planar, shared):
    """Source rows and maxC shared by the batch (the slide-level case,
    stride 0) or one per tile (stride 6 and 2), as float32 device tensors
    and as arrays; the target shared."""
    M, mc = _params(cuda)
    rgb = torch.from_numpy(he_batch(6, 256, 256, seed=103)).to(cuda)
    planar_x = fs.to_planar(rgb).contiguous()
    Ms, mcs = mf.macenko_fit_planar(planar_x)
    Ms, mcs = Ms.contiguous(), mcs.contiguous()
    if shared:
        Ms, mcs = Ms[2], mcs[2]
    x = planar_x if planar else rgb
    got = _k3_bytes(x, planar, Ms, mcs, M, mc)
    assert torch.equal(got, _k3_bytes(x, planar, Ms.cpu().numpy(),
                                      mcs.cpu().numpy(), M.cpu(), mc))
    assert torch.equal(fs.from_planar(got, 256, 256) if planar else got,
                       mf.normalize_with_matrix(
                           rgb, Ms.expand(6, 2, 3) if shared else Ms,
                           mcs.expand(6, 2) if shared else mcs, M, mc))


@pytest.mark.cuda
@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("offset", [1, 7, 8])
def test_k3_takes_unaligned_views(cuda, planar, offset):
    """A contiguous view that starts ``offset`` bytes into its buffer: the
    vector groups start after a scalar head (interleaved) or move byte by
    byte (planar)."""
    M, mc = _params(cuda)
    rgb = torch.from_numpy(he_batch(2, 128, 128, seed=104)).to(cuda)
    src = fs.to_planar(rgb).contiguous() if planar else rgb
    buf = torch.zeros(src.numel() + 32, dtype=torch.uint8, device=cuda)
    x = buf[offset:offset + src.numel()].view(src.shape)
    x.copy_(src)
    assert x.is_contiguous() and x.data_ptr() % 8 == offset % 8
    Ms, mcs = extractive.estimate_source(rgb[:, ::2, ::2])
    assert torch.equal(_k3_bytes(x, planar, Ms, mcs, M, mc),
                       _k3_bytes(src, planar, Ms, mcs, M, mc))


@pytest.mark.cuda
def test_k3_odd_interleaved_images(cuda):
    """255x255 images: an odd pixel count, so each image after the first
    starts off the vector grid and every image has a tail."""
    M, mc = _params(cuda)
    rgb = torch.from_numpy(he_batch(3, 255, 255, seed=105)).to(cuda)
    Ms, mcs = extractive.estimate_source(rgb[:, ::2, ::2])
    got = _k3_bytes(rgb, False, Ms, mcs, M, mc)
    assert torch.equal(_k3_bytes(rgb[1:2].contiguous(), False, Ms[1],
                                 mcs[1], M, mc)[0], got[1])


@pytest.mark.cuda
def test_k3_takes_more_than_65535_tiles(cuda):
    """65,537 planar tiles of 128 pixels in one launch (the persistent grid
    has no per-image grid dimension)."""
    M, mc = _params(cuda)
    x = torch.from_numpy(np.random.default_rng(106).integers(
        0, 256, (65537, 3, 1, 128), dtype=np.uint8)).to(cuda)
    Ms, mcs = extractive.estimate_source(
        torch.from_numpy(he_batch(1, 64, 64, seed=107)).to(cuda))
    rows = Ms.expand(65537, 2, 3).contiguous()
    rows = rows * (1.0 + torch.linspace(0.0, 0.1, 65537, device=cuda)
                   )[:, None, None]
    maxc = mcs.expand(65537, 2).contiguous()
    _k3_bytes(x, True, rows, maxc, M, mc)


def _k10_within(planar, g=None):
    got = mf._eigen_launch(planar, g=g)
    want = mf.eigenplane_ref(planar)
    assert got.shape == want.shape == (planar.shape[0], 3, 2)
    assert float((got - want).abs().max()) <= 1e-6, g
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("batch,side", [(256, 256), (1, 256), (16, 512)])
def test_k10_equals_plain_at_every_cluster_size(cuda, batch, side):
    """Within 1e-6 of the plain version, the same bits at every G and on a
    rerun, and a tile's plane the same alone as in its batch."""
    rgb = torch.from_numpy(he_batch(batch, side, side, seed=108)).to(cuda)
    planar = fs.to_planar(rgb).contiguous()
    before = mf.eigenplane_launches
    V = mf.eigenplane(planar)
    assert mf.eigenplane_launches == before + 1
    for g in mf.CLUSTER_SIZES:
        assert torch.equal(_k10_within(planar, g), V), g
    assert torch.equal(mf.eigenplane(planar), V)
    k = batch // 2
    assert torch.equal(mf.eigenplane(planar[k:k + 1].contiguous())[0], V[k])


@pytest.mark.cuda
def test_k10_all_background_tile(cuda):
    """A tile with no tissue pixel: zero moments, the clamped scale and the
    degenerate eigenvector, as the plain version."""
    tiles = he_batch(3, 256, 256, seed=109)
    tiles[1] = 255
    planar = fs.to_planar(torch.from_numpy(tiles).to(cuda)).contiguous()
    V = _k10_within(planar)
    assert torch.equal(V[1], mf.eigenplane_ref(planar)[1])
    assert V[1].tolist() == [[1.0, 1.0], [0.0, 0.0], [0.0, 0.0]]
