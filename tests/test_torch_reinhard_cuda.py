"""The hand-written CUDA Reinhard kernel (K5) against its plain PyTorch
version, and the drop-in ``ReinhardStainNormalizer`` on the card.

Needs a CUDA device (marker ``cuda``; every test skips without one). The
card has no jax, so this file imports only torch, numpy and the port. On
the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_reinhard_cuda.py

Tolerance: at most 1 uint8 step on under 0.1% of the bytes. The kernel's
brightness percentile is exact (a histogram of bytes), its linearization
table is the plain version's, and its six LAB sums are double sums rounded
once, like the plain version's float64 sums.
"""

import numpy as np
import pytest
import torch

import stainlib_tpu_torch as st
from stainlib_tpu_torch.kernels import fused_stain as fs
from stainlib_tpu_torch.kernels import reinhard_fused as rf
from stainlib_tpu_torch.normalization import reinhard
from synth import he_batch, he_patch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _params(device):
    p = reinhard.fit(torch.from_numpy(he_patch(256, 256, seed=110)))
    return p.means.to(device), p.stds.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("side,batch", [(256, 8), (512, 2), (32, 4)])
def test_k5_matches_plain_version(cuda, side, batch):
    means, stds = _params(cuda)
    rgb = torch.from_numpy(he_batch(batch, side, side, seed=111)).to(cuda)
    before = rf.launches
    got = rf.reinhard_normalize(rgb, means, stds)
    assert rf.launches == before + 1
    want = rf.reinhard_normalize_ref(rgb, means, stds)
    d = (got.int() - want.int()).abs()
    assert d.max() <= 1 and (d > 0).float().mean() < 1e-3, (
        int(d.max()), float((d > 0).float().mean()))
    planar = rf.reinhard_normalize_planar(fs.to_planar(rgb).contiguous(),
                                          means, stds)
    assert torch.equal(fs.from_planar(planar, side, side), got)
    # The same bytes as the plain version evaluated on the CPU.
    cpu = rf.reinhard_normalize(rgb.cpu(), means.cpu(), stds.cpu())
    d = (got.cpu().int() - cpu.int()).abs()
    assert d.max() <= 1 and (d > 0).float().mean() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("side,batch", [(256, 1), (256, 3), (512, 1),
                                        (512, 2), (64, 2)])
@pytest.mark.parametrize("planar", [False, True])
def test_k5_same_bytes_at_every_cluster_size(cuda, side, batch, planar):
    """Every cluster size the plan can choose, and G=1, give the plain
    version's bytes, on an H&E tile, a white one and a dark one."""
    means, stds = _params(cuda)
    tiles = he_batch(batch, side, side, seed=114)
    if batch > 1:
        tiles[-1] = 255
    if batch > 2:
        tiles[-2] = np.random.default_rng(115).integers(
            0, 40, tiles[-2].shape, dtype=np.uint8)
    rgb = torch.from_numpy(tiles).to(cuda)
    x = fs.to_planar(rgb).contiguous() if planar else rgb
    want = (rf.reinhard_normalize_planar_ref if planar
            else rf.reinhard_normalize_ref)(x, means, stds)
    for g in rf.CLUSTER_SIZES:
        got = rf._launch(x, planar, means, stds, g=g)
        assert torch.equal(got, want), g
    planned = (rf.reinhard_normalize_planar if planar
               else rf.reinhard_normalize)(x, means, stds)
    assert torch.equal(planned, want)


@pytest.mark.cuda
def test_k5_per_tile_targets_and_unaligned_views(cuda):
    """Per-tile target statistics by pointer; a contiguous view that starts
    at an odd byte of its buffer."""
    means, stds = _params(cuda)
    rgb = torch.from_numpy(he_batch(3, 128, 128, seed=116)).to(cuda)
    scale = torch.tensor([[1.0], [0.9], [1.1]], device=cuda)
    pm, ps = means[None] * scale, stds[None] * scale
    got = rf.reinhard_normalize(rgb, pm, ps)
    assert torch.equal(got, rf.reinhard_normalize_ref(rgb, pm, ps))
    assert torch.equal(got[0], rf.reinhard_normalize(rgb[:1], means, stds)[0])
    assert torch.equal(rf.reinhard_normalize(rgb, pm.cpu().numpy(),
                                             ps.cpu().tolist()), got)
    buf = torch.zeros(rgb.numel() + 16, dtype=torch.uint8, device=cuda)
    view = buf[3:3 + rgb.numel()].view(rgb.shape)
    view.copy_(rgb)
    assert view.data_ptr() % 16 == 3
    assert torch.equal(rf.reinhard_normalize(view, pm, ps), got)


@pytest.mark.cuda
def test_k5_deterministic_and_per_tile(cuda):
    """Identical bytes on a second run; a tile's output does not depend on
    its batch neighbours; a white tile and a one-value tile stay finite."""
    means, stds = _params(cuda)
    tiles = he_batch(8, 256, 256, seed=112)
    tiles[5] = 255
    tiles[6] = 90
    rgb = torch.from_numpy(tiles).to(cuda)
    a = rf.reinhard_normalize(rgb, means, stds)
    assert torch.equal(a, rf.reinhard_normalize(rgb, means, stds))
    one = rf.reinhard_normalize(rgb[3:4].contiguous(), means, stds)
    assert torch.equal(one[0], a[3])
    want = rf.reinhard_normalize_ref(rgb, means, stds)
    assert torch.equal(a[5:7], want[5:7])


@pytest.mark.cuda
def test_dropin_reinhard_on_the_card(cuda):
    norm = st.ReinhardStainNormalizer(device=cuda)
    norm.fit(he_patch(256, 256, seed=110))
    img = he_patch(256, 256, seed=113)
    before = rf.launches
    out = norm.transform(img)
    assert rf.launches == before + 1
    assert out.dtype == np.uint8 and out.shape == img.shape
    masked = norm.transform(img, mask_background=True)  # functional path
    assert rf.launches == before + 1
    assert masked.dtype == np.uint8 and masked[:32].min() > 240
    with pytest.raises(st.TissueMaskException):
        norm.transform(np.full((16, 16, 3), 255, np.uint8),
                       mask_background=True)


@pytest.mark.cuda
def test_wrapper_rejects_strided_input(cuda):
    means, stds = _params(cuda)
    rgb = torch.from_numpy(he_batch(2, 256, 256, seed=99)).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rf.reinhard_normalize(rgb.transpose(1, 2), means, stds)
