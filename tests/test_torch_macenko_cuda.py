"""The hand-written CUDA Macenko kernel against its plain PyTorch version.

Needs a CUDA device (marker ``cuda``; every test skips without one). The
card has no jax, so this file imports only torch, numpy and the port. On
the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_macenko_cuda.py

Tolerance: at most 1 uint8 step, on under 0.1% of the bytes; the two
differ only in the order of the kernel's float32 moment sums.
"""

import numpy as np
import pytest
import torch

from stainlib_tpu_torch.kernels import macenko_fused as mf
from stainlib_tpu_torch.normalization import extractive
from synth import he_batch, he_patch

FAST = dict(fit_stride=2, n_bisect=10)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _params(device):
    p = extractive.fit(torch.from_numpy(he_patch(256, 256, seed=90)))
    return p.stain_matrix_target.to(device), p.max_c_target.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("side,batch", [(256, 8), (512, 2), (32, 2)])
@pytest.mark.parametrize("kw", [{}, FAST], ids=["fs1", "fs2"])
def test_cuda_kernel_matches_plain_version(cuda, side, batch, kw):
    M, mc = _params(cuda)
    rgb = torch.from_numpy(he_batch(batch, side, side, seed=97)).to(cuda)
    before = mf.launches
    got = mf.macenko_normalize(rgb, M, mc, **kw)
    assert mf.launches == before + 1
    want = mf.macenko_normalize_ref(rgb, M, mc, **kw)
    d = (got.int() - want.int()).abs()
    assert d.max() <= 1 and (d > 0).float().mean() < 1e-3, (
        int(d.max()), float((d > 0).float().mean()))
    planar = mf.macenko_normalize_planar(mf.to_planar(rgb).contiguous(), M,
                                         mc, **kw)
    assert torch.equal(mf.from_planar(planar, side, side), got)


@pytest.mark.cuda
def test_cuda_kernel_deterministic_and_per_tile(cuda):
    """Identical bytes on a second run; a tile's output does not depend on
    its batch neighbours."""
    M, mc = _params(cuda)
    rgb = torch.from_numpy(he_batch(8, 256, 256, seed=98)).to(cuda)
    a = mf.macenko_normalize(rgb, M, mc, **FAST)
    b = mf.macenko_normalize(rgb, M, mc, **FAST)
    assert torch.equal(a, b)
    one = mf.macenko_normalize(rgb[3:4].contiguous(), M, mc, **FAST)
    assert torch.equal(one[0], a[3])


@pytest.mark.cuda
def test_cuda_wrapper_rejects_strided_input(cuda):
    M, mc = _params(cuda)
    rgb = torch.from_numpy(he_batch(2, 256, 256, seed=99)).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        mf.macenko_normalize(rgb.transpose(1, 2), M, mc)
    out = np.asarray(mf.macenko_normalize(rgb, M, mc).cpu())
    assert out.dtype == np.uint8 and out.shape == (2, 256, 256, 3)


def _tiles_with_white(side, seed, cuda):
    """Three tiles: H&E, H&E with its upper half white, all white."""
    tiles = he_batch(2, side, side, seed=seed)
    tiles[1, : side // 2] = 255
    tiles = np.concatenate([tiles, np.full_like(tiles[:1], 255)])
    return torch.from_numpy(tiles).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("side,kw", [(128, {}), (256, FAST), (256, {}),
                                     (512, FAST), (512, {}), (1024, {})],
                         ids=["128-fs1", "256-fs2", "256-fs1", "512-fs2",
                              "512-fs1", "1024-fs1"])
def test_k1_cluster_equals_plain_at_every_cluster_size(cuda, side, kw):
    """K1's bytes equal the plain version's at each cluster size G (forced
    through ``cluster_plan``'s ``g``), interleaved and planar, whether the
    slices are staged in shared or in device memory (1024^2 at fs=1, and
    the small G of the others), with a half-white and an all-white tile in
    the batch; two runs are identical."""
    M, mc = _params(cuda)
    rgb = _tiles_with_white(side, 104, cuda)
    planar = mf.to_planar(rgb).contiguous()
    want = mf.macenko_normalize_ref(rgb, M, mc, **kw)
    want_planar = mf.to_planar(want)
    for g in mf.CLUSTER_SIZES:
        got = mf._launch(rgb, False, M, mc, g=g, **kw)
        assert torch.equal(got, want), (g, int(
            (got.int() - want.int()).abs().max()))
        assert torch.equal(mf._launch(planar, True, M, mc, g=g, **kw),
                           want_planar), g
    got = mf.macenko_normalize(rgb, M, mc, **kw)
    assert torch.equal(got, want)
    assert torch.equal(mf.macenko_normalize(rgb, M, mc, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,g,shared", [(1, 16, True), (3, 16, True),
                                            (70, 2, False)])
def test_k1_plan_follows_the_batch(cuda, batch, g, shared):
    """One image and three run at the plan's G for their batch (16 blocks
    per tile, staged in shared memory), 70 tiles as two blocks per tile
    staged in device memory, and give the bytes of G = 1; a tile's output
    does not depend on the batch it came in."""
    M, mc = _params(cuda)
    rgb = torch.from_numpy(he_batch(batch, 256, 256, seed=105)).to(cuda)
    plan = mf.cluster_plan(32768, "K1", batch=batch)
    assert plan.g == g and (plan.smem > 0) == shared
    got = mf.macenko_normalize(rgb, M, mc, **FAST)
    assert torch.equal(got, mf._launch(rgb, False, M, mc, g=1, **FAST))
    assert torch.equal(got, mf.macenko_normalize_ref(rgb, M, mc, **FAST))
    one = mf.macenko_normalize(rgb[-1:].contiguous(), M, mc, **FAST)
    assert torch.equal(one[0], got[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("offset", [1, 7, 8])
def test_k1_takes_unaligned_views(cuda, planar, offset):
    """A contiguous view that starts ``offset`` bytes into its buffer: the
    apply pass's vector groups start after a scalar head (interleaved) or
    move byte by byte (planar)."""
    M, mc = _params(cuda)
    rgb = torch.from_numpy(he_batch(2, 128, 128, seed=106)).to(cuda)
    src = mf.to_planar(rgb).contiguous() if planar else rgb
    buf = torch.zeros(src.numel() + 32, dtype=torch.uint8, device=cuda)
    x = buf[offset:offset + src.numel()].view(src.shape)
    x.copy_(src)
    assert x.is_contiguous() and x.data_ptr() % 8 == offset % 8
    fn = mf.macenko_normalize_planar if planar else mf.macenko_normalize
    for g in (1, 4):
        got = mf._launch(x, planar, M, mc, g=g)
        assert torch.equal(got, fn(src, M, mc)), g
    want = mf.macenko_normalize_ref(rgb, M, mc)
    assert torch.equal(fn(x, M, mc),
                       mf.to_planar(want) if planar else want)
