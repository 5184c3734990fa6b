"""The hand-written CUDA stain-augmentation kernels (K6 fused Macenko
augment, K7 augment apply) against their plain PyTorch versions, and the
augmentation routes on the card.

Needs a CUDA device (marker ``cuda``; every test skips without one). The
card has no jax, so this file imports only torch, numpy and the port. On
the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_augment_cuda.py

Tolerances: uint8 outputs at most 1 step apart on under 0.1% of the bytes
(kernel and plain version share the OD/luminance tables and sum the
moments in double / float64; on the card they have been byte-identical);
the fused routes within the JAX tests' functional budget (<=1 u8 on >99%
of bytes, max <=4).
"""

import numpy as np
import pytest
import torch

import stainlib_tpu_torch as st
from stainlib_tpu_torch.augmentation import functional as F
from stainlib_tpu_torch.kernels import _build
from stainlib_tpu_torch.kernels import fused_stain as fs
from stainlib_tpu_torch.kernels import macenko_fused as mf
from stainlib_tpu_torch.kernels import vahadane_fused as vf
from synth import he_batch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _draws(n, seed, device):
    return F._stain_draws(torch.Generator().manual_seed(seed), (n,), 0.2, 0.2,
                          device)


def _u8_close(got, want):
    d = (got.int() - want.int()).abs()
    assert d.max() <= 1 and (d > 0).float().mean() < 1e-3, (
        int(d.max()), float((d > 0).float().mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("side,batch", [(256, 8), (512, 2)])
@pytest.mark.parametrize("background", [False, True])
def test_k6_k7_match_plain_versions(cuda, side, batch, background):
    rgb = torch.from_numpy(he_batch(batch, side, side, seed=97)).to(cuda)
    planar = fs.to_planar(rgb).contiguous()
    alpha, beta = _draws(batch, 1, cuda)
    kw = dict(augment_background=background)
    before = (mf.aug_launches, mf.augment_launches)
    k6 = mf.macenko_augment_planar(planar, alpha, beta, **kw)
    _u8_close(k6, mf.macenko_augment_planar_ref(planar, alpha, beta, **kw))
    assert torch.equal(mf.macenko_augment(rgb, alpha, beta, **kw),
                       fs.from_planar(k6, side, side))
    M = vf._prior_where_nan(vf.vahadane_stain_matrix_planar_ref(planar))
    k7 = mf.augment_with_matrix_planar(planar, M, alpha, beta, **kw)
    _u8_close(k7, mf.augment_with_matrix_planar_ref(planar, M, alpha, beta,
                                                    **kw))
    assert torch.equal(mf.augment_with_matrix(rgb, M, alpha, beta, **kw),
                       fs.from_planar(k7, side, side))
    assert (mf.aug_launches, mf.augment_launches) == (before[0] + 2,
                                                      before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["macenko", "vahadane"])
def test_stain_augment_routes_and_budget(cuda, method):
    """<=512^2: K6 (Macenko) or K8 + K7 (Vahadane), one launch each, the
    same draws as the functional fit + pop and within its budget."""
    rgb = torch.from_numpy(he_batch(4, 256, 256, seed=98)).to(cuda)
    before = (mf.aug_launches, mf.augment_launches, vf.dict_launches)
    got = F.stain_augment(rgb, torch.Generator().manual_seed(3), method)
    want_counts = ((1, 0, 0) if method == "macenko" else (0, 1, 1))
    assert tuple(a - b for a, b in zip(
        (mf.aug_launches, mf.augment_launches, vf.dict_launches),
        before)) == want_counts
    alpha, beta = _draws(4, 3, "cpu")
    want = F._stain_augment_pop_apply(
        F.stain_augment_fit(rgb.cpu(), method), alpha, beta)
    d = (got.cpu().int() - want.int()).abs()
    assert d.max() <= 4 and (d <= 1).float().mean() > 0.99, (
        int(d.max()), float((d > 1).float().mean()))
    assert torch.equal(
        F.stain_augment(rgb, torch.Generator().manual_seed(3), method), got)


@pytest.mark.cuda
def test_large_field_route_is_one_k7_launch(cuda):
    field = torch.from_numpy(he_batch(1, 1024, 1024, seed=99)[0]).to(cuda)
    before = (mf.aug_launches, mf.augment_launches)
    got = F.stain_augment(field, torch.Generator().manual_seed(4))
    assert (mf.aug_launches - before[0],
            mf.augment_launches - before[1]) == (0, 1)
    alpha, beta = (x.reshape(1, 2) for x in F._stain_draws(
        torch.Generator().manual_seed(4), (), 0.2, 0.2, cuda))
    blocks = F._augment_field(field[None], alpha, beta, "macenko", block=512)
    assert torch.equal(blocks[0], got)
    M = vf._prior_where_nan(F._EXTRACTORS["macenko"](field[None]))
    _u8_close(got, mf.augment_with_matrix_ref(field[None], M, alpha,
                                              beta)[0])


@pytest.mark.cuda
def test_stain_augmentor_pops_through_k7(cuda):
    img = he_batch(1, 256, 256, seed=100)[0]
    aug = st.StainAugmentor("macenko", seed=7, device=cuda)
    aug.fit(img)
    before = mf.augment_launches
    pops = [aug.pop() for _ in range(3)]
    assert mf.augment_launches == before + 3
    assert all((a != b).any() for a, b in zip(pops, pops[1:]))
    gen = torch.Generator().manual_seed(7)
    params = F.stain_augment_fit(torch.from_numpy(img), "macenko")
    for got in pops:
        a, b = F._stain_draws(gen, (1,), 0.2, 0.2, "cpu")
        want = F._stain_augment_pop_apply(params, a[0], b[0]).numpy()
        assert np.quantile(np.abs(got.astype(int) - want.astype(int)),
                           0.99) <= 4


@pytest.mark.cuda
def test_failed_launch_raises_without_fallback(cuda, monkeypatch):
    """A refused launch raises; nothing falls back to the plain version or
    the functional path, and no launch is counted."""

    class RefusingLibrary:
        def __getattr__(self, name):
            if name == "stain_error_string":
                return lambda err: b"refused for the test"
            return lambda *args: 1  # cudaErrorInvalidValue

    rgb = torch.from_numpy(he_batch(2, 256, 256, seed=101)).to(cuda)
    alpha, beta = _draws(2, 5, cuda)
    _build.load_library()
    monkeypatch.setattr(_build, "_lib", RefusingLibrary())
    before = (mf.aug_launches, mf.augment_launches)
    with pytest.raises(RuntimeError, match="^augment_launch failed"):
        mf.macenko_augment(rgb, alpha, beta)
    with pytest.raises(RuntimeError, match="augment_apply_launch failed"):
        mf.augment_with_matrix(rgb, torch.eye(2, 3, device=cuda), alpha,
                               beta)
    with pytest.raises(RuntimeError, match="^augment_launch failed"):
        F.stain_augment(rgb, torch.Generator().manual_seed(0))
    assert (mf.aug_launches, mf.augment_launches) == before


@pytest.mark.cuda
def test_kernels_deterministic_and_per_tile(cuda):
    rgb = torch.from_numpy(he_batch(8, 256, 256, seed=102)).to(cuda)
    alpha, beta = _draws(8, 6, cuda)
    out = mf.macenko_augment(rgb, alpha, beta)
    assert torch.equal(mf.macenko_augment(rgb, alpha, beta), out)
    one = mf.macenko_augment(rgb[3:4].contiguous(), alpha[3:4], beta[3:4])
    assert torch.equal(one[0], out[3])
    vout = vf.vahadane_augment(rgb, alpha, beta)
    assert torch.equal(vf.vahadane_augment(rgb, alpha, beta), vout)
    with pytest.raises(ValueError, match="contiguous"):
        mf.macenko_augment_planar(fs.to_planar(rgb), alpha, beta)
