"""The stain-augmentation kernels' plain PyTorch versions and wrappers:
the fused Macenko augment (K6), the augment apply (K7) and the Vahadane
augment (K8 then K7).

On the CPU the wrappers run the plain versions, which are held to the JAX
Pallas kernels in interpret mode (at most 1 uint8 step apart, at least
99.9% identical: ``test_torch_macenko_kernel.py``'s budget), and to the
port's functional fit + pop within the budget that
``tests/test_macenko_fused.py:82-83`` sets for the TPU kernel (<=1 u8 on
>99% of bytes, max <=4). The CUDA kernels themselves are tested in
``test_torch_augment_cuda.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stainlib_tpu.extraction.macenko import stain_matrix_macenko as jax_mac  # noqa: E402
from stainlib_tpu.kernels import macenko_fused as jax_mf  # noqa: E402
from stainlib_tpu.kernels import vahadane_fused as jax_vf  # noqa: E402
from stainlib_tpu_torch.augmentation import functional as F  # noqa: E402
from stainlib_tpu_torch.kernels import macenko_fused as mf  # noqa: E402
from stainlib_tpu_torch.kernels import vahadane_fused as vf  # noqa: E402
from tests.synth import he_batch  # noqa: E402


def _diff(got, want):
    return np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))


def _draws(n, seed, sigma=0.2):
    """Per-image per-stain alpha~U(1+-sigma), beta~U(+-sigma), from numpy."""
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(1 - sigma, 1 + sigma, (n, 2)).astype(np.float32)
    beta = rng.uniform(-sigma, sigma, (n, 2)).astype(np.float32)
    return alpha, beta


def _close_to_jax(got, want):
    d = _diff(got, want)
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(),
                                                      (d == 0).mean())


@pytest.mark.parametrize("shape", [(32, 64), (64, 128)])
@pytest.mark.parametrize("background", [False, True])
def test_plain_k6_matches_jax_kernel(shape, background):
    batch = he_batch(2, *shape, seed=210)
    alpha, beta = _draws(2, 1)
    want = jax_mf.macenko_augment(jnp.asarray(batch), alpha, beta,
                                  augment_background=background,
                                  interpret=True)
    got = mf.macenko_augment(torch.from_numpy(batch), alpha, beta,
                             augment_background=background)
    _close_to_jax(got.numpy(), want)


@pytest.mark.parametrize("shape", [(32, 64), (64, 128)])
@pytest.mark.parametrize("background", [False, True])
def test_plain_k7_matches_jax_kernel(shape, background):
    batch = he_batch(2, *shape, seed=212)
    M = np.asarray(jax_mac(jnp.asarray(batch)))
    alpha, beta = _draws(2, 2, sigma=0.3)
    planar = jnp.asarray(batch).transpose(0, 3, 1, 2).reshape(2, 3, -1, 128)
    want = jax_mf.augment_with_matrix_planar(planar, M, alpha, beta,
                                             augment_background=background,
                                             interpret=True)
    tp = mf.to_planar(torch.from_numpy(batch)).contiguous()
    got = mf.augment_with_matrix_planar(tp, M, alpha, beta,
                                        augment_background=background)
    _close_to_jax(got.numpy(), want)
    # The interleaved entry of any size gives the same bytes.
    inter = mf.augment_with_matrix(torch.from_numpy(batch), M, alpha, beta,
                                   augment_background=background)
    assert torch.equal(mf.from_planar(got, *shape), inter)


def test_plain_vahadane_augment_matches_jax():
    """K8 then K7 (the JAX route: dictionary kernel, prior where NaN,
    augment apply), the second tile all white (empty mask -> prior)."""
    batch = he_batch(2, 32, 64, seed=220)
    batch[1] = 255
    alpha, beta = _draws(2, 3)
    want = jax_vf.vahadane_augment(jnp.asarray(batch), alpha, beta,
                                   interpret=True)
    got = vf.vahadane_augment(torch.from_numpy(batch), alpha, beta)
    _close_to_jax(got.numpy(), want)
    assert (got[1] == 255).all()


@pytest.mark.parametrize("method", ["macenko", "vahadane"])
def test_plain_fused_routes_against_functional(method):
    """The fused kernels' plain versions against the port's functional
    fit + pop with the same draws (``test_macenko_fused.py:82-83``,
    ``test_vahadane_fused.py:73-74``)."""
    batch = torch.from_numpy(he_batch(2, 32, 64, seed=220))
    alpha, beta = (torch.from_numpy(a) for a in _draws(2, 4))
    fused = mf.macenko_augment if method == "macenko" else vf.vahadane_augment
    got = fused(batch, alpha, beta)
    want = F._stain_augment_pop_apply(F.stain_augment_fit(batch, method),
                                      alpha, beta)
    d = _diff(got, want)
    assert (d <= 1).mean() > 0.99 and d.max() <= 4, (d.max(),
                                                     (d > 1).mean())


def test_plain_k6_background_gate():
    """``augment_background=False`` keeps non-tissue pixels at their
    unperturbed reconstruction (``test_macenko_fused.py:86-106``)."""
    batch = torch.from_numpy(he_batch(1, 32, 64, seed=211))
    alpha = torch.tensor([[1.5, 1.5]])
    beta = torch.tensor([[0.3, 0.3]])
    gated = mf.macenko_augment(batch, alpha, beta)
    ungated = mf.macenko_augment(batch, alpha, beta, augment_background=True)
    top_g = gated[0, :4].to(torch.float64)
    top_u = ungated[0, :4].to(torch.float64)
    assert top_g.mean() > top_u.mean() + 10, (top_g.mean(), top_u.mean())
    # Gated background equals the alpha=1, beta=0 reconstruction there.
    plain = mf.macenko_augment(batch, torch.ones(1, 2), torch.zeros(1, 2))
    assert torch.equal(gated[0, :4], plain[0, :4])


@pytest.mark.parametrize("background", [False, True])
def test_large_field_route_blocked_equals_whole(background):
    """The >512^2 route: K7 over the whole interleaved field equals the
    JAX-style 512^2-blockified route byte for byte (plain versions)."""
    field = torch.from_numpy(he_batch(1, 520, 530, seed=230))
    alpha, beta = (torch.from_numpy(a) for a in _draws(1, 5))
    whole = F._augment_field(field, alpha, beta, "macenko", background)
    blocks = F._augment_field(field, alpha, beta, "macenko", background,
                              block=512)
    assert whole.shape == field.shape and whole.dtype == torch.uint8
    assert torch.equal(whole, blocks)


def test_wrappers_on_cpu_tensors():
    """CPU tensors take the plain versions (no launch); malformed input
    raises."""
    rgb = torch.from_numpy(he_batch(2, 32, 64, seed=96))
    M = torch.tensor(np.asarray(jax_mac(jnp.asarray(rgb.numpy()))))
    alpha, beta = (torch.from_numpy(a) for a in _draws(2, 6))
    before = (mf.aug_launches, mf.augment_launches, vf.dict_launches)
    out = mf.macenko_augment(rgb, alpha, beta)
    planar = mf.macenko_augment_planar(mf.to_planar(rgb).contiguous(), alpha,
                                       beta)
    vf.vahadane_augment(rgb, alpha, beta)
    mf.augment_with_matrix(rgb, M, alpha, beta)
    assert (mf.aug_launches, mf.augment_launches,
            vf.dict_launches) == before
    assert out.dtype == torch.uint8 and out.shape == rgb.shape
    assert torch.equal(mf.from_planar(planar, 32, 64), out)
    # Shared draws broadcast over the batch.
    assert torch.equal(mf.macenko_augment(rgb, alpha[0], beta[0])[0], out[0])
    with pytest.raises(TypeError):
        mf.macenko_augment(rgb.float(), alpha, beta)
    with pytest.raises(ValueError):
        mf.macenko_augment(rgb[:, :, :3], alpha, beta)  # 96 px: not lanes
    with pytest.raises(ValueError):
        mf.augment_with_matrix_planar(rgb, M, alpha, beta)


def test_augment_args_strides_and_values():
    """K7's pointer arguments: shared values get stride 0, per-tile values
    their width; numpy, list and CPU-tensor forms convert to the same
    float32 values; a ready float32 tensor is passed without a copy."""
    cpu = torch.device("cpu")
    M = np.asarray([[0.56, 0.72, 0.41], [0.22, 0.80, 0.56]], np.float32)
    alpha, beta = _draws(4, 7)
    per_tile = np.stack([M, M * 0.9, M * 1.1, M])
    for rows, a, b, want in ((M, alpha[0], beta[0], (0, 0, 0)),
                             (per_tile, alpha, beta, (6, 2, 2)),
                             (M, alpha, beta[0], (0, 2, 0))):
        forms = [(rows, a, b), (rows.tolist(), a.tolist(), b.tolist()),
                 tuple(torch.from_numpy(v) for v in (rows, a, b)),
                 tuple(torch.from_numpy(v).double() for v in (rows, a, b))]
        for form in forms:
            args = mf._augment_args(*form, 4, cpu)
            assert tuple(stride for _, stride in args) == want
            for (t, _), v in zip(args, (rows, a, b)):
                assert t.dtype == torch.float32 and t.is_contiguous()
                np.testing.assert_array_equal(t.numpy().ravel(), v.ravel())
    ready = [torch.from_numpy(v) for v in (per_tile, alpha, beta)]
    for (t, _), r in zip(mf._augment_args(*ready, 4, cpu), ready):
        assert t.data_ptr() == r.data_ptr()
    # A view that is not contiguous is laid out once; B=1 is "shared".
    spread = torch.from_numpy(alpha[0]).expand(4, 2)
    t, stride = mf._augment_args(M, spread, beta, 4, cpu)[1]
    assert stride == 2 and t.is_contiguous() and torch.equal(t, spread)
    assert [st for _, st in mf._augment_args(M, alpha[:1], beta[:1], 1,
                                             cpu)] == [0, 0, 0]
    for bad in (alpha[:3], alpha.ravel()[:5]):
        with pytest.raises(ValueError, match="expected 2 values"):
            mf._augment_args(M, bad, beta, 4, cpu)


@pytest.mark.parametrize("planar", [False, True])
def test_k7_entry_same_bytes_for_every_argument_form(planar):
    batch = torch.from_numpy(he_batch(2, 32, 64, seed=214))
    x = mf.to_planar(batch).contiguous() if planar else batch
    fn = mf.augment_with_matrix_planar if planar else mf.augment_with_matrix
    M = np.array(jax_mac(jnp.asarray(batch.numpy())))
    alpha, beta = _draws(2, 8)
    want = fn(x, torch.from_numpy(M), torch.from_numpy(alpha),
              torch.from_numpy(beta))
    for conv in (np.asarray, lambda v: v.tolist(),
                 lambda v: torch.from_numpy(v).double()):
        assert torch.equal(fn(x, conv(M), conv(alpha), conv(beta)), want)
    # Shared values equal the same values repeated per tile.
    shared = fn(x, M[0], alpha[0], beta[0])
    assert torch.equal(shared, fn(x, np.stack([M[0]] * 2),
                                  np.stack([alpha[0]] * 2),
                                  np.stack([beta[0]] * 2)))
