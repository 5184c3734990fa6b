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
