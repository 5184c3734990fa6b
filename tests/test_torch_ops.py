"""The port's functional ops against the JAX package's, on the CPU.

Same numpy inputs on both sides. Tolerances: float32 atol 1e-5 scaled by
the field's magnitude (LAB channels reach ~100 and RGB 255, where one ulp
is ~1e-5), relative 1e-5 for percentiles, bitwise for masks and counts.
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests.synth import he_batch  # noqa: E402

J = {n: importlib.import_module(f"stainlib_tpu.ops.{n}")
     for n in ("colorspace", "tissue", "percentile", "linalg3", "lasso")}
T = {n: importlib.import_module(f"stainlib_tpu_torch.ops.{n}")
     for n in ("colorspace", "tissue", "percentile", "linalg3", "lasso")}


def _images():
    rng = np.random.default_rng(0)
    return [he_batch(2, 32, 48, seed=3),
            rng.integers(0, 256, (2, 32, 48, 3)).astype(np.uint8)]


def _close(want, got, rel=1e-5):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    atol = rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["rgb_to_od", "lab_luminance", "rgb_to_lab"])
def test_colorspace_forward(name):
    for img in _images():
        want = getattr(J["colorspace"], name)(jnp.asarray(img))
        got = getattr(T["colorspace"], name)(torch.from_numpy(img))
        _close(want, got.numpy())


def test_lab_to_rgb_and_to_uint8():
    img = _images()[1]
    lab = np.array(J["colorspace"].rgb_to_lab(jnp.asarray(img)))
    want = np.asarray(J["colorspace"].lab_to_rgb(jnp.asarray(lab)))
    got = T["colorspace"].lab_to_rgb(torch.from_numpy(lab)).numpy()
    _close(want, got)
    x = np.linspace(-20, 280, 301, dtype=np.float32)
    assert (np.asarray(J["colorspace"].to_uint8(jnp.asarray(x)))
            == T["colorspace"].to_uint8(torch.from_numpy(x)).numpy()).all()


def test_tissue_mask_bitwise():
    for img in _images():
        want = J["tissue"].tissue_mask(jnp.asarray(img))
        got = T["tissue"].tissue_mask(torch.from_numpy(img))
        assert (np.asarray(want.mask) == got.mask.numpy()).all()
        assert (np.asarray(want.count) == got.count.numpy()).all()
        assert got.count.dtype == torch.int32


def test_luminosity_and_brightness_standardize():
    img = _images()[0]
    for name in ("luminosity_standardize", "standardize_brightness"):
        want = getattr(J["tissue"], name)(jnp.asarray(img))
        got = getattr(T["tissue"], name)(torch.from_numpy(img))
        _close(want, got.numpy())


@pytest.mark.parametrize("q", [99.0, [1.0, 50.0, 99.0]])
def test_percentile_and_masked_percentile_sort_path(q):
    rng = np.random.default_rng(1)
    v = rng.normal(size=(3, 1000)).astype(np.float32)
    m = rng.random((3, 1000)) < 0.5
    qj = jnp.asarray(q, jnp.float32)
    for axis in (-1, None, (-1,)):
        want = J["percentile"].percentile(jnp.asarray(v), qj, axis=axis)
        got = T["percentile"].percentile(torch.from_numpy(v), q, axis=axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    want = J["percentile"].masked_percentile(jnp.asarray(v), jnp.asarray(m),
                                             qj)
    got = T["percentile"].masked_percentile(torch.from_numpy(v),
                                            torch.from_numpy(m), q)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    # An empty mask on the sort path: NaN, as in the JAX package.
    empty = T["percentile"].masked_percentile(
        torch.from_numpy(v), torch.zeros(3, 1000, dtype=torch.bool), q)
    assert np.isnan(np.asarray(J["percentile"].masked_percentile(
        jnp.asarray(v), jnp.zeros((3, 1000), bool), qj))).all()
    assert torch.isnan(empty).all()


def test_percentile_bisect_path_and_empty_mask():
    """A 600x600 axis (> 512^2) takes count bisection on both sides."""
    rng = np.random.default_rng(2)
    v = (rng.random((2, 600 * 600)) ** 3).astype(np.float32)
    m = rng.random((2, 600 * 600)) < 0.3
    m[1] = False
    q = [1.0, 99.0]
    want = np.asarray(J["percentile"].masked_percentile(
        jnp.asarray(v), jnp.asarray(m), jnp.asarray(q, jnp.float32)))
    got = T["percentile"].masked_percentile(
        torch.from_numpy(v), torch.from_numpy(m), q).numpy()
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5)
    assert np.isposinf(got[:, 1]).all() and np.isposinf(want[:, 1]).all()
    want = np.asarray(J["percentile"].percentile(jnp.asarray(v), 99.0,
                                                 axis=-1))
    got = T["percentile"].percentile(torch.from_numpy(v), 99.0, axis=-1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(want, np.percentile(v, 99.0, axis=-1),
                               rtol=1e-5)


def test_eigh3x3_values_and_sign_fixed_vectors():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1)
    wj, Vj = (np.asarray(x) for x in J["linalg3"].eigh3x3(jnp.asarray(A)))
    wt, Vt = (x.numpy() for x in T["linalg3"].eigh3x3(torch.from_numpy(A)))
    # Scale-relative: the solve normalizes by max|A| first.
    scale = np.abs(A).max(axis=(1, 2))[:, None]
    np.testing.assert_allclose(wt / scale, wj / scale, rtol=0, atol=1e-5)
    np.testing.assert_allclose(Vt, Vj, rtol=0, atol=1e-5)
    # Columns are eigenvectors with the largest-|.| component positive.
    lead = np.take_along_axis(Vt, np.abs(Vt).argmax(1)[:, None, :], 1)
    assert (lead > 0).all()


def test_nonneg_lasso_k2():
    rng = np.random.default_rng(4)
    od = (rng.random((500, 3)) * 2).astype(np.float32)
    M = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]], np.float32)
    M /= np.linalg.norm(M, axis=1, keepdims=True)
    want = np.asarray(J["lasso"].nonneg_lasso_k2(jnp.asarray(od),
                                                 jnp.asarray(M)))
    got = T["lasso"].nonneg_lasso_k2(torch.from_numpy(od),
                                     torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got >= 0).all() and (got == 0).any()


@pytest.mark.parametrize("name", ["rgb_to_od", "rgb_to_hed", "rgb_to_lab",
                                  "lab_luminance"])
def test_uint8_table_path_equals_float_path_on_every_byte(name):
    """uint8 input takes each channel's transcendental from a 256-entry
    table; it must give the bits of the float64-evaluated float path on all
    256 values of every channel."""
    fn = getattr(T["colorspace"], name)
    v = torch.arange(256, dtype=torch.uint8)
    rng = np.random.default_rng(5)
    img = torch.stack([v, v.flip(0), torch.from_numpy(
        rng.permutation(256).astype(np.uint8))], dim=-1)[None]  # (1, 256, 3)
    gray = torch.stack([v, v, v], dim=-1)[None]
    for x in (img, gray, torch.from_numpy(_images()[1])):
        assert torch.equal(fn(x), fn(x.to(torch.float32)))


@pytest.mark.parametrize("kind", ["random", "near_degenerate"])
def test_eigh3x3_f64_against_numpy(kind):
    """The extractor's float64 solve against ``numpy.linalg.eigh``:
    eigenvalues to 1e-6 of the largest, eigenvectors up to sign where the
    eigenvalue is separated; float32 outputs."""
    rng = np.random.default_rng(11)
    a = rng.normal(size=(64, 200, 3)) * np.array([1.0, 0.5, 0.1])
    if kind == "near_degenerate":  # two eigenvalues 1e-4 apart (relative)
        q, _ = np.linalg.qr(rng.normal(size=(64, 3, 3)))
        lam = np.stack([np.full(64, 0.1), np.full(64, 1.0),
                        np.full(64, 1.0001)], -1)
        cov = np.einsum("bij,bj,bkj->bik", q, lam, q)
    else:
        cov = np.einsum("bni,bnj->bij", a, a) / 199.0
    cov = cov.astype(np.float32)
    cov = (cov + cov.transpose(0, 2, 1)) / 2  # exactly symmetric in float32
    w, V = T["linalg3"].eigh3x3_f64(torch.from_numpy(cov))
    assert w.dtype == torch.float32 and V.dtype == torch.float32
    w_np, V_np = np.linalg.eigh(cov.astype(np.float64))
    scale = np.abs(w_np).max(-1, keepdims=True)
    np.testing.assert_allclose(w.numpy(), w_np, rtol=0,
                               atol=1e-6 * float(scale.max()))
    cols = (0,) if kind == "near_degenerate" else (0, 1, 2)
    for k in cols:
        dot = np.abs(np.einsum("bi,bi->b", V.numpy()[..., k], V_np[..., k]))
        np.testing.assert_allclose(dot, 1.0, atol=1e-5)
    # The plane of the two close eigenvalues is the complement of column 0.
    G = V.numpy().astype(np.float64)
    np.testing.assert_allclose(np.einsum("bij,bik->bjk", G, G),
                               np.broadcast_to(np.eye(3), (64, 3, 3)),
                               atol=2e-3 if kind == "near_degenerate"
                               else 1e-5)
    # The float32 solve, which K10's glue keeps, stays as it was: it cannot
    # split eigenvalues 1e-4 apart, the float64 one can.
    w32, _ = T["linalg3"].eigh3x3(torch.from_numpy(cov))
    err32 = float(np.abs(w32.numpy() - w_np).max())
    assert err32 < 1e-5 * float(scale.max()) or kind == "near_degenerate"
    assert (err32 > 2e-5) == (kind == "near_degenerate")


# HSD, delta-E and FISTA (``colorspace.py:218-250``, ``delta_e.py:16-30``,
# ``lasso.py:92-118``). Tolerances: HSD coordinates atol 1e-5 (measured
# 5e-7: float64 log in the port, float32 in JAX) and its inverse 1e-5 of
# 255; delta-E per pixel atol 2e-4 (the LAB channels' 1e-5 of 100, summed
# in squares) and the report's p95 the same; FISTA atol 1e-5 (measured
# 7e-6 after 200 iterations).

def test_hsd_round_trip_matches_jax():
    jc, tc = J["colorspace"], T["colorspace"]
    for img in _images():
        want = np.asarray(jc.rgb_to_hsd(jnp.asarray(img)))
        got = tc.rgb_to_hsd(torch.from_numpy(img)).numpy()
        _close(want, got)
        back = tc.hsd_to_rgb(torch.from_numpy(want.copy())).numpy()
        _close(np.asarray(jc.hsd_to_rgb(jnp.asarray(want))), back)
        # The inverse recovers the clipped [1, 254] input.
        np.testing.assert_allclose(back, np.clip(img, 1, 254), atol=2e-3)


def test_delta_e_matches_jax():
    from stainlib_tpu.ops import delta_e as jd
    from stainlib_tpu_torch.ops import delta_e as td

    a, b = _images()
    want = np.asarray(jd.delta_e76(jnp.asarray(a), jnp.asarray(b)))
    got = td.delta_e76(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == a.shape[:-1]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    assert float(td.delta_e76(torch.from_numpy(a),
                              torch.from_numpy(a)).max()) == 0.0
    np.testing.assert_allclose(
        float(td.mean_delta_e(torch.from_numpy(a), torch.from_numpy(b))),
        float(jd.mean_delta_e(jnp.asarray(a), jnp.asarray(b))), atol=2e-4)
    for g, w in zip(td.delta_e_report(torch.from_numpy(a),
                                      torch.from_numpy(b)),
                    jd.delta_e_report(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(float(g), float(w), atol=2e-4)


def test_nonneg_lasso_fista_matches_jax_and_k2():
    rng = np.random.default_rng(2)
    X = rng.random((200, 3)).astype(np.float32)
    D = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]], np.float32)
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    want = np.asarray(J["lasso"].nonneg_lasso_fista(X, D, 0.01))
    got = T["lasso"].nonneg_lasso_fista(torch.from_numpy(X),
                                        torch.from_numpy(D), 0.01).numpy()
    assert got.shape == (200, 2) and (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    exact = T["lasso"].nonneg_lasso_k2(torch.from_numpy(X),
                                       torch.from_numpy(D), 0.01).numpy()
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-3)


def test_percentile_sequence_q_above_bisection_threshold():
    """Sequence q over an axis longer than 512^2 (the count-bisection
    route): q-leading stacking, within 2e-3 of numpy and of JAX
    (``tests/test_slide_normalize.py:308-319``)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 600_000)).astype(np.float32)
    q = [1.0, 50.0, 99.0]
    got = T["percentile"].percentile(torch.from_numpy(x), q, axis=-1).numpy()
    assert got.shape == (3, 2)
    want = np.stack([np.percentile(x, v, axis=-1) for v in q])
    np.testing.assert_allclose(got, want, atol=2e-3)
    jax_got = np.asarray(J["percentile"].percentile(jnp.asarray(x), q,
                                                    axis=-1))
    np.testing.assert_allclose(got, jax_got, atol=2e-3)
