"""The port's Vahadane dictionary learner, extraction, extractive
fit/transform and drop-in classes against the JAX package's, on the CPU.

Same numpy tiles on both sides (``tests/synth.py``). Tolerances:

* dictionaries and stain matrices: atol 2e-5 against JAX (measured
  2e-6 at 64^2, 8e-6 at 256^2: the JAX path sums its two pixel
  contractions in float32, the port in float64) and atol 1e-5 against a
  float64 numpy evaluation of the same algorithm;
* uint8 outputs: at most 1 step apart, and at least 99.9% identical.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import stainlib_tpu as jsl  # noqa: E402
import stainlib_tpu_torch as tsl  # noqa: E402
from stainlib_tpu.extraction.vahadane import stain_matrix_vahadane as jax_sv  # noqa: E402
from stainlib_tpu.normalization import extractive as jax_ex  # noqa: E402
from stainlib_tpu.ops.colorspace import rgb_to_od as jax_od  # noqa: E402
from stainlib_tpu.ops.dictlearn import fit_stain_dictionary as jax_fit  # noqa: E402
from stainlib_tpu.ops.tissue import tissue_mask as jax_mask  # noqa: E402
from stainlib_tpu_torch.convert import params_from_jax  # noqa: E402
from stainlib_tpu_torch.extraction.vahadane import stain_matrix_vahadane  # noqa: E402
from stainlib_tpu_torch.normalization import extractive  # noqa: E402
from stainlib_tpu_torch.ops.dictlearn import _HE_INIT, fit_stain_dictionary  # noqa: E402
from tests.synth import HE_TRUE, he_batch, he_patch  # noqa: E402

WHITE = np.full((16, 16, 3), 255, np.uint8)


def _u8_close(got, want):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(),
                                                      (d == 0).mean())


def _macenko_f64(od, q=99.0):
    """Macenko rows in float64 numpy from the tissue pixels' OD (N, 3)."""
    _, V = np.linalg.eigh(np.cov(od, rowvar=False))
    V = V[:, [2, 1]]
    V = V * np.where(V[0] < 0, -1.0, 1.0)
    proj = od @ V
    phi = np.arctan2(proj[:, 1], proj[:, 0])
    lo, hi = np.percentile(phi, 100 - q), np.percentile(phi, q)
    v1, v2 = V @ [np.cos(lo), np.sin(lo)], V @ [np.cos(hi), np.sin(hi)]
    HE = np.array([v1, v2]) if v1[0] > v2[0] else np.array([v2, v1])
    return HE / np.linalg.norm(HE, axis=1, keepdims=True)


def _lasso_f64(od, D, lam):
    """The exact non-negative K=2 lasso in float64, (N, 3) -> (N, 2)."""
    g11, g22, g12 = D[0] @ D[0], D[1] @ D[1], D[0] @ D[1]
    det = max(g11 * g22 - g12 * g12, 1e-12)
    b1, b2 = od @ D[0] - lam, od @ D[1] - lam
    c1f, c2f = (g22 * b1 - g12 * b2) / det, (g11 * b2 - g12 * b1) / det
    okf = (c1f >= 0) & (c2f >= 0)
    c1o, c2o = np.maximum(b1, 0) / g11, np.maximum(b2, 0) / g22
    ok1 = (b1 >= 0) & (g12 * c1o - b2 >= 0)
    ok2 = (b2 >= 0) & (g12 * c2o - b1 >= 0)
    c1 = np.where(okf, c1f, np.where(ok1, c1o, 0.0))
    c2 = np.where(okf, c2f, np.where(~ok1 & ok2, c2o, 0.0))
    return np.stack([c1, c2], -1)


def _dictionary_f64(od, D, lam=0.1, num_iters=12):
    """fit_stain_dictionary in float64 on the tissue pixels' OD."""
    D = D.astype(np.float64).copy()
    for _ in range(num_iters):
        A = _lasso_f64(od, D, lam)
        C, B = A.T @ A, A.T @ od
        for _sweep in range(2):
            for j in range(2):
                u = D[j] + (B[j] - C[j] @ D) / max(C[j, j], 1e-8)
                u = np.maximum(u, 0.0)
                u = u / max(np.linalg.norm(u), 1.0)
                if u.sum() > 0:
                    D[j] = u
    return D


def _vahadane_f64(img, mask):
    """stain_matrix_vahadane in float64 numpy for one image."""
    od = np.maximum(-np.log(np.maximum(img.astype(np.float64), 1.0) / 255.0),
                    1e-6).reshape(-1, 3)[mask.reshape(-1)]
    D = _dictionary_f64(od, _macenko_f64(od))
    if D[0, 0] < D[1, 0]:
        D = D[::-1]
    return D / np.linalg.norm(D, axis=1, keepdims=True)


def test_fit_stain_dictionary_matches_jax():
    """Identical OD, mask and start on both sides; both starts."""
    batch = he_batch(2, 48, 64, seed=81)
    od = np.array(jax_od(jnp.asarray(batch))).reshape(2, -1, 3)
    mask = np.array(jax_mask(jnp.asarray(batch)).mask).reshape(2, -1)
    init = np.stack([_HE_INIT, _HE_INIT[::-1]]).astype(np.float32)
    for start in (None, init):
        want = np.asarray(jax_fit(od, mask, num_iters=12, init=start))
        got = fit_stain_dictionary(torch.from_numpy(od),
                                   torch.from_numpy(mask), num_iters=12,
                                   init=start).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
        assert (got >= 0).all()
        assert (np.linalg.norm(got, axis=-1) <= 1.0 + 1e-6).all()


@pytest.mark.parametrize("side", [64, 128])
def test_stain_matrix_vahadane_matches_jax_and_float64(side):
    batch = he_batch(2, side, side, seed=91)
    got = stain_matrix_vahadane(torch.from_numpy(batch)).numpy()
    want = np.asarray(jax_sv(jnp.asarray(batch)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    masks = np.asarray(jax_mask(jnp.asarray(batch)).mask)
    f64 = np.stack([_vahadane_f64(b, m) for b, m in zip(batch, masks)])
    np.testing.assert_allclose(got, f64, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    assert (got[:, 0, 0] >= got[:, 1, 0]).all()  # H first
    # An empty tissue mask gives NaN rows on both sides.
    assert torch.isnan(stain_matrix_vahadane(torch.from_numpy(WHITE))).all()
    assert np.isnan(np.asarray(jax_sv(jnp.asarray(WHITE)))).all()


def test_fit_and_transform_vahadane_match_jax():
    target = he_patch(64, 64, seed=90)
    batch = he_batch(2, 64, 64, seed=91)
    jp = jax_ex.fit(jnp.asarray(target), method="vahadane")
    tp = extractive.fit(torch.from_numpy(target), method="Vahadane")
    np.testing.assert_allclose(tp.stain_matrix_target.numpy(),
                               np.asarray(jp.stain_matrix_target), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(tp.max_c_target.numpy(),
                               np.asarray(jp.max_c_target), rtol=1e-4)
    want = np.asarray(jax_ex.transform(jp, jnp.asarray(batch),
                                       method="vahadane"))
    got = extractive.transform(tp, torch.from_numpy(batch),
                               method="vahadane").numpy()
    assert got.dtype == np.uint8 and got.shape == batch.shape
    _u8_close(got, want)
    M, mc = extractive.estimate_source(torch.from_numpy(batch),
                                       method="vahadane")
    jM, jmc = jax_ex.estimate_source(jnp.asarray(batch), method="vahadane")
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), atol=2e-5)
    np.testing.assert_allclose(mc.numpy(), np.asarray(jmc), rtol=1e-4)
    with pytest.raises(KeyError):
        extractive.fit(torch.from_numpy(target), method="nope")


def test_params_from_jax_carries_a_vahadane_fit():
    """JAX Vahadane fit -> the port's Vahadane transform equals JAX's."""
    target = he_patch(64, 64, seed=92)
    batch = he_batch(2, 64, 64, seed=93)
    jp = jax_ex.fit(jnp.asarray(target), method="vahadane")
    tp = params_from_jax(np.asarray(jp.stain_matrix_target),
                         np.asarray(jp.max_c_target), "cpu")
    assert (tp.stain_matrix_target.numpy()
            == np.asarray(jp.stain_matrix_target)).all()
    assert (tp.max_c_target.numpy() == np.asarray(jp.max_c_target)).all()
    want = np.asarray(jax_ex.transform(jp, jnp.asarray(batch),
                                       method="vahadane"))
    got = extractive.transform(tp, torch.from_numpy(batch),
                               method="vahadane").numpy()
    _u8_close(got, want)


def test_dropin_vahadane_classes_match_jax():
    """Single images through both drop-in classes; on a CPU both take the
    functional route."""
    target, img = he_patch(48, 48, seed=57), he_patch(48, 48, seed=56)
    jn = jsl.ExtractiveStainNormalizer("vahadane")
    tn = tsl.ExtractiveStainNormalizer("vahadane", device="cpu")
    jn.fit(target)
    tn.fit(target)
    np.testing.assert_allclose(tn.stain_matrix_target, jn.stain_matrix_target,
                               rtol=0, atol=2e-5)
    assert tn.maxC_target.shape == (1, 2)
    np.testing.assert_allclose(tn.maxC_target, jn.maxC_target, rtol=1e-4)
    out = tn.transform(img)
    assert out.dtype == np.uint8 and out.shape == img.shape
    _u8_close(out, jn.transform(img))

    M = tsl.VahadaneStainExtractor.get_stain_matrix(img, device="cpu")
    assert M.shape == (2, 3) and (M >= 0).all()
    np.testing.assert_allclose(
        M, jsl.VahadaneStainExtractor.get_stain_matrix(img), atol=2e-5)


def test_vahadane_raise_contract():
    """The reference's raises on an empty tissue mask and bad input."""
    with pytest.raises(tsl.TissueMaskException):
        tsl.VahadaneStainExtractor.get_stain_matrix(WHITE, device="cpu")
    with pytest.raises(AssertionError):
        tsl.VahadaneStainExtractor.get_stain_matrix(
            np.zeros((8, 8, 3), np.float32), device="cpu")
    norm = tsl.ExtractiveStainNormalizer("vahadane", device="cpu")
    with pytest.raises(RuntimeError):
        norm.transform(he_patch(32, 32, seed=52))
    with pytest.raises(tsl.TissueMaskException):
        norm.fit(WHITE)
    norm.fit(he_patch(48, 48, seed=50))
    with pytest.raises(tsl.TissueMaskException):
        norm.transform(WHITE)


def test_vahadane_recovers_generating_stains():
    """``tests/test_extraction.py:82-91`` at 64^2: the rows point along the
    stains the synthetic image was made from."""
    img = he_patch(64, 64, seed=13)
    M = stain_matrix_vahadane(torch.from_numpy(img)).numpy()
    assert M.shape == (2, 3) and (M >= 0).all()
    assert M[0, 0] >= M[1, 0]
    for k in range(2):
        assert M[k] @ HE_TRUE[k] > 0.98, (k, M, HE_TRUE)
