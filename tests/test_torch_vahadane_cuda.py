"""The hand-written CUDA Vahadane kernels (K2 fit+transform, K8
dictionary) and the fixed-matrix normalize kernel (K9), each one
thread-block cluster per tile, against their plain PyTorch versions.

Needs a CUDA device (marker ``cuda``; every test skips without one). The
card has no jax, so this file imports only torch, numpy and the port. On
the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_vahadane_cuda.py

Tolerances: uint8 outputs at most 1 step apart on under 0.1% of the bytes;
stain matrices at atol 1e-5. Kernel and plain version differ only in the
order of their float32 sums (moments, the nine BCD sums per iteration).
"""

import numpy as np
import pytest
import torch

from stainlib_tpu_torch.kernels import _build
from stainlib_tpu_torch.kernels import fused_stain as fs
from stainlib_tpu_torch.kernels import macenko_fused as mf
from stainlib_tpu_torch.kernels import vahadane_fused as vf
from stainlib_tpu_torch.normalization import extractive
from synth import he_batch, he_patch

VFAST = dict(fit_stride=2, num_iters=8, n_bisect=10)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _params(device):
    p = extractive.fit(torch.from_numpy(he_patch(256, 256, seed=90)),
                       method="vahadane")
    return p.stain_matrix_target.to(device), p.max_c_target.to(device)


def _u8_close(got, want):
    d = (got.int() - want.int()).abs()
    assert d.max() <= 1 and (d > 0).float().mean() < 1e-3, (
        int(d.max()), float((d > 0).float().mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("side,batch", [(256, 8), (512, 2), (32, 8)])
@pytest.mark.parametrize("kw", [{}, VFAST], ids=["fs1", "fs2"])
def test_cuda_kernels_match_plain_versions(cuda, side, batch, kw):
    M, mc = _params(cuda)
    rgb = torch.from_numpy(he_batch(batch, side, side, seed=97)).to(cuda)
    planar = fs.to_planar(rgb).contiguous()
    got = vf.vahadane_normalize(rgb, M, mc, **kw)
    _u8_close(got, vf.vahadane_normalize_ref(rgb, M, mc, **kw))
    assert torch.equal(fs.from_planar(
        vf.vahadane_normalize_planar(planar, M, mc, **kw), side, side), got)

    dict_kw = dict(fit_stride=kw.get("fit_stride", 1),
                   num_iters=kw.get("num_iters", 12),
                   n_bisect=kw.get("n_bisect", 14))
    m_got = vf.vahadane_stain_matrix_planar(planar, **dict_kw)
    m_want = vf.vahadane_stain_matrix_planar_ref(planar, **dict_kw)
    assert float((m_got - m_want).abs().max()) <= 1e-5

    k9 = fs.fused_normalize_planar(planar, m_want, M, mc)
    _u8_close(k9, fs.fused_normalize_planar_ref(planar, m_want, M, mc))
    assert torch.equal(
        fs.fused_normalize(rgb, m_want, M, mc),
        fs.from_planar(k9, side, side))


@pytest.mark.cuda
def test_cuda_kernels_deterministic_and_per_tile(cuda):
    """Identical bytes on a second run; a tile's output does not depend on
    its batch neighbours; an empty-mask tile gives white and NaN rows."""
    M, mc = _params(cuda)
    tiles = he_batch(8, 256, 256, seed=98)
    tiles[5] = 255
    rgb = torch.from_numpy(tiles).to(cuda)
    planar = fs.to_planar(rgb).contiguous()
    a = vf.vahadane_normalize(rgb, M, mc, **VFAST)
    assert torch.equal(a, vf.vahadane_normalize(rgb, M, mc, **VFAST))
    one = vf.vahadane_normalize(rgb[3:4].contiguous(), M, mc, **VFAST)
    assert torch.equal(one[0], a[3])
    assert (a[5] == 255).all()
    m = vf.vahadane_stain_matrix_planar(planar)
    assert torch.allclose(m, vf.vahadane_stain_matrix_planar(planar),
                          rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(m[5]).all() and not torch.isnan(m[:5]).any()
    m[5] = M
    k9 = fs.fused_normalize_planar(planar, m, M, mc)
    assert torch.equal(k9, fs.fused_normalize_planar(planar, m, M, mc))
    assert torch.equal(
        fs.fused_normalize_planar(planar[3:4].contiguous(), m[3:4], M,
                                  mc)[0], k9[3])


@pytest.mark.cuda
def test_cuda_launch_counters(cuda):
    """Each wrapper counts its own kernel's launches, once per call."""
    M, mc = _params(cuda)
    rgb = torch.from_numpy(he_batch(2, 256, 256, seed=99)).to(cuda)
    planar = fs.to_planar(rgb).contiguous()
    before = (vf.launches, vf.dict_launches, fs.launches)
    vf.vahadane_normalize(rgb, M, mc, **VFAST)
    assert (vf.launches, vf.dict_launches, fs.launches) == (
        before[0] + 1, before[1], before[2])
    vf.vahadane_normalize_planar_2k(planar, M, mc)
    assert (vf.launches, vf.dict_launches, fs.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    vf.vahadane_normalize_ref(rgb, M, mc, **VFAST)
    assert (vf.launches, vf.dict_launches, fs.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)


@pytest.mark.cuda
def test_cuda_wrappers_reject_strided_input(cuda):
    M, mc = _params(cuda)
    rgb = torch.from_numpy(he_batch(2, 256, 256, seed=99)).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        vf.vahadane_normalize(rgb.transpose(1, 2), M, mc)
    with pytest.raises(ValueError, match="contiguous"):
        vf.vahadane_stain_matrix_planar(fs.to_planar(rgb))
    with pytest.raises(ValueError, match="contiguous"):
        fs.fused_normalize_planar(fs.to_planar(rgb), M.expand(2, 2, 3), M, mc)
    out = np.asarray(vf.vahadane_normalize(rgb, M, mc).cpu())
    assert out.dtype == np.uint8 and out.shape == (2, 256, 256, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("side,kw", [(128, {}), (256, VFAST), (512, {}),
                                     (512, VFAST), (1024, {})],
                         ids=["128-fs1", "256-fs2", "512-fs1", "512-fs2",
                              "1024-fs1"])
def test_k2_cluster_equals_plain_at_every_cluster_size(cuda, side, kw):
    """K2's bytes equal the plain version's at each G the plan can take for
    the tile's sample (forced through ``cluster_plan``'s ``g``), whether
    the slices are staged in shared or in device memory (1024^2 at fs=1,
    and the small G of the others), with an all-white tile in the batch;
    two runs are identical."""
    M, mc = _params(cuda)
    tiles = he_batch(2, side, side, seed=103)
    tiles[1, : side // 2] = 255
    tiles = np.concatenate([tiles, np.full_like(tiles[:1], 255)])
    rgb = torch.from_numpy(tiles).to(cuda)
    want = vf.vahadane_normalize_ref(rgb, M, mc, **kw)
    for g in mf.CLUSTER_SIZES:
        got = vf._launch(rgb, False, M, mc, g=g, **kw)
        assert torch.equal(got, want), (g, int(
            (got.int() - want.int()).abs().max()))
    assert (want[2] == 255).all()
    got = vf.vahadane_normalize(rgb, M, mc, **kw)
    assert torch.equal(got, want)
    assert torch.equal(vf.vahadane_normalize(rgb, M, mc, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("side,kw", [
    (128, {}), (256, {}), (256, dict(fit_stride=2, n_bisect=10)), (512, {}),
    (512, dict(fit_stride=2, num_iters=8)), (1024, dict(num_iters=4))],
    ids=["128-fs1", "256-fs1", "256-fs2", "512-fs1", "512-fs2", "1024-fs1"])
def test_k8_cluster_equals_plain_at_every_cluster_size(cuda, side, kw):
    """K8's eight floats per tile equal the plain version's, bit for bit,
    at each cluster size G (forced through ``cluster_plan``'s ``g``),
    whether the slices are staged in shared or in device memory (1024^2,
    and the small G of the others), with a half-white and an all-white
    tile in the batch: NaN rows for the white tile after the post-pass; two
    runs are identical."""
    tiles = he_batch(2, side, side, seed=107)
    tiles[1, : side // 2] = 255
    tiles = np.concatenate([tiles, np.full_like(tiles[:1], 255)])
    planar = fs.to_planar(torch.from_numpy(tiles).to(cuda)).contiguous()
    want = vf._dict_plane_ref(planar, **kw)
    for g in mf.CLUSTER_SIZES:
        got = vf._dict_launch(planar, g=g, **kw)
        assert torch.equal(got, want), (g, float((got - want).abs().max()))
    m = vf.vahadane_stain_matrix_planar(planar, **kw)
    assert torch.isnan(m[2]).all() and not torch.isnan(m[:2]).any()
    m_want = vf.vahadane_stain_matrix_planar_ref(planar, **kw)
    assert torch.equal(m[:2], m_want[:2])
    again = vf.vahadane_stain_matrix_planar(planar, **kw)
    assert torch.equal(again[:2], m[:2]) and torch.isnan(again[2]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("batch,g,shared", [(1, 16, True), (3, 16, True),
                                            (70, 2, False)])
def test_k8_plan_follows_the_batch(cuda, batch, g, shared):
    """One image and three run at the plan's G for their batch (16 blocks
    per tile, staged in shared memory), 70 tiles as two blocks per tile
    staged in device memory, and give the floats of G = 1; a tile's rows do
    not depend on the batch it came in."""
    rgb = torch.from_numpy(he_batch(batch, 256, 256, seed=108)).to(cuda)
    planar = fs.to_planar(rgb).contiguous()
    plan = mf.cluster_plan(65536, "K8", batch=batch)
    assert plan.g == g and (plan.smem > 0) == shared
    before = vf.dict_launches
    got = vf.vahadane_stain_matrix_planar(planar)
    assert vf.dict_launches == before + 1
    assert torch.equal(got, vf._dict_post(vf._dict_launch(planar, g=1)))
    assert torch.equal(got, vf.vahadane_stain_matrix_planar_ref(planar))
    one = vf.vahadane_stain_matrix_planar(planar[-1:].contiguous())
    assert torch.equal(one[0], got[-1])


def _tiles_with_white(batch, side, seed, device):
    """``batch`` H&E tiles; of three, the second with its upper half white
    and the third all white (K8 gives it NaN rows, which K9 then reads)."""
    tiles = he_batch(batch, side, side, seed=seed)
    if batch >= 3:
        tiles[1, : side // 2] = 255
        tiles[2] = 255
    return torch.from_numpy(tiles).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("side", [256, 512])
def test_k9_cluster_equals_plain_at_every_cluster_size(cuda, side, batch):
    """K9's bytes equal the plain version's at each cluster size G (forced
    through ``cluster_plan``'s ``g``), planar and interleaved, staged in
    shared or in device memory, given K8's per-tile rows (NaN for the
    all-white tile of a batch of three); the plan's own G gives the same
    bytes, twice."""
    M, mc = _params(cuda)
    rgb = _tiles_with_white(batch, side, 150, cuda)
    planar = fs.to_planar(rgb).contiguous()
    m = vf.vahadane_stain_matrix_planar_ref(planar)
    assert torch.isnan(m).any() == (batch >= 3)
    want = fs.fused_normalize_planar_ref(planar, m, M, mc)
    want_rgb = fs.from_planar(want, side, side)
    for g in mf.CLUSTER_SIZES:
        got = fs._launch(planar, True, m, M, mc, g=g)
        assert torch.equal(got, want), (g, int(
            (got.int() - want.int()).abs().max()))
        assert torch.equal(fs._launch(rgb, False, m, M, mc, g=g),
                           want_rgb), g
    got = fs.fused_normalize_planar(planar, m, M, mc)
    assert torch.equal(got, want)
    assert torch.equal(fs.fused_normalize_planar(planar, m, M, mc), got)
    assert torch.equal(fs.fused_normalize(rgb, m, M, mc), want_rgb)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,side,g,shared", [
    (1, 256, 16, True), (3, 256, 16, True), (70, 256, 4, False),
    (12, 512, 16, False)])
def test_k9_plan_follows_the_batch(cuda, batch, side, g, shared):
    """One image and three of 256^2 run at the plan's G for their batch (16
    blocks per tile, staged in shared memory), 70 tiles as four blocks per
    tile staged in device memory, 12 of 512^2 as 16 blocks per tile staged
    in device memory, and give the bytes of G = 1; a tile's output does not
    depend on the batch it came in."""
    M, mc = _params(cuda)
    rgb = torch.from_numpy(he_batch(batch, side, side, seed=151)).to(cuda)
    planar = fs.to_planar(rgb).contiguous()
    m = vf.vahadane_stain_matrix_planar_ref(planar)
    plan = mf.cluster_plan(side * side, "K9", batch=batch)
    assert plan.g == g and (plan.smem > 0) == shared
    before = fs.launches
    got = fs.fused_normalize_planar(planar, m, M, mc)
    assert fs.launches == before + 1
    assert torch.equal(got, fs._launch(planar, True, m, M, mc, g=1))
    assert torch.equal(got, fs.fused_normalize_planar_ref(planar, m, M, mc))
    one = fs.fused_normalize_planar(planar[-1:].contiguous(), m[-1:], M, mc)
    assert torch.equal(one[0], got[-1])


@pytest.mark.cuda
def test_k9_argument_forms(cuda):
    """numpy, list and CPU-tensor arguments, shared or per tile, give the
    bytes of the CUDA tensors the kernel reads by their own pointer."""
    M, mc = _params(cuda)
    rgb = torch.from_numpy(he_batch(3, 128, 128, seed=152)).to(cuda)
    planar = fs.to_planar(rgb).contiguous()
    m = vf.vahadane_stain_matrix_planar_ref(planar)
    want = fs.fused_normalize_planar(planar, m, M, mc)
    for conv in (lambda t: t.cpu().numpy(), lambda t: t.cpu().tolist(),
                 lambda t: t.cpu(), lambda t: t.double()):
        assert torch.equal(fs.fused_normalize_planar(
            planar, conv(m), conv(M), conv(mc)), want)
    per_tile = fs.fused_normalize_planar(planar, m, M.expand(3, 2, 3),
                                         mc.expand(3, 2))
    assert torch.equal(per_tile, want)


@pytest.mark.cuda
def test_k9_failed_launch_raises_without_fallback(cuda, monkeypatch):
    """A refused launch raises; nothing falls back to the plain version,
    and no launch is counted."""

    class RefusingLibrary:
        def __getattr__(self, name):
            if name == "stain_error_string":
                return lambda err: b"refused for the test"
            return lambda *args: 1  # cudaErrorInvalidValue

    M, mc = _params(cuda)
    rgb = torch.from_numpy(he_batch(2, 256, 256, seed=153)).to(cuda)
    planar = fs.to_planar(rgb).contiguous()
    m = M.expand(2, 2, 3)
    _build.load_library()
    monkeypatch.setattr(_build, "_lib", RefusingLibrary())
    before = fs.launches
    with pytest.raises(RuntimeError, match="^fused_normalize_launch failed"):
        fs.fused_normalize_planar(planar, m, M, mc)
    with pytest.raises(RuntimeError, match="^fused_normalize_launch failed"):
        fs.fused_normalize(rgb, m, M, mc)
    assert fs.launches == before
