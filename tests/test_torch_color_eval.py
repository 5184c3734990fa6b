"""The colour transfer and NMI functions: the port against the JAX package.

Every function of ``models/color_eval.py`` on the same numpy inputs: HSD
tiles of the synthetic multi-center cohort and responsibilities with one
empty class (zero mass: flat cumulative weights, repeated quantile knots).

Budgets: the statistics rtol 1e-5, atol 1e-6 (sums over pixels round in
another order than XLA's; the port adds in float64 and rounds once, and it
must be at least as close to a float64 evaluation as JAX is); every
transfer's uint8 output within 1 on all but 1e-3 of the bytes, at most 2;
NMI within 1e-5, ``nmi_per_class`` equal where the uint8 images are;
``match_classes_by_usage`` equal; ``_interp`` equal to ``jnp.interp`` bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stainlib_tpu.data.synthetic import multi_center_batches
from stainlib_tpu.models import color_eval as jce
from stainlib_tpu.ops.colorspace import hsd_to_rgb as j_hsd_to_rgb
from stainlib_tpu.ops.colorspace import rgb_to_hsd as j_rgb_to_hsd
from stainlib_tpu_torch.models import color_eval as tce

STAT_TOL = dict(rtol=1e-5, atol=1e-6)
K = 4
PERM = np.array([2, 0, 3, 1], np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _cohort(seed):
    rgb, _ = multi_center_batches(range(4), 1, 4, 16, 16, seed=seed)
    return np.asarray(j_rgb_to_hsd(jnp.asarray(rgb[0])), np.float32)


def _gamma(seed, empty=True):
    logits = np.random.default_rng(seed).normal(0, 2, (4, 16, 16, K))
    if empty:
        logits[..., K - 1] = -1e4  # class K-1 holds no mass
    return np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))


@pytest.fixture(scope="module")
def data():
    src, tmpl = _cohort(1), _cohort(2)
    g_s, g_t = _gamma(3), _gamma(4, empty=False)
    out = dict(src=src, tmpl=tmpl, g_s=g_s, g_t=g_t)
    for space in ("hsd", "rgb"):
        x_s = src if space == "hsd" else np.asarray(j_hsd_to_rgb(src))
        x_t = tmpl if space == "hsd" else np.asarray(j_hsd_to_rgb(tmpl))
        out[space] = dict(
            x_s=x_s, x_t=x_t,
            stats_s=jce.class_color_stats(x_s, g_s),
            stats_t=jce.class_color_stats(x_t, g_t),
            cov_s=jce.class_color_cov(x_s, g_s),
            cov_t=jce.class_color_cov(x_t, g_t),
            q_s=jce.class_channel_quantiles(x_s, g_s)[0],
            q_t=jce.class_channel_quantiles(x_t, g_t)[0])
    return out


def _f64_stats(x, g):
    """mu, sigma, cov in float64 from the same inputs."""
    x = np.asarray(x, np.float64).reshape(-1, 3)
    w = np.asarray(g, np.float64).reshape(-1, g.shape[-1])
    tot = w.sum(0) + 1e-6
    mu = w.T @ x / tot[:, None]
    sq = w.T @ (x * x) / tot[:, None]
    sigma = np.sqrt(np.maximum(sq - mu * mu, 1e-6))
    xx = np.einsum("nk,nc,nd->kcd", w, x, x) / tot[:, None, None]
    cov = xx - mu[:, :, None] * mu[:, None, :] + 1e-6 * np.eye(3)
    return dict(mu=mu, sigma=sigma, cov=cov)


@pytest.mark.parametrize("space", ["hsd", "rgb"])
@pytest.mark.parametrize("fn", ["class_color_stats", "class_color_cov",
                                "class_channel_quantiles", "class_usage"])
def test_class_statistics_match_jax(data, fn, space):
    x, g = data[space]["x_s"], data["g_s"]
    args = (g,) if fn == "class_usage" else (x, g)
    want = getattr(jce, fn)(*args)
    got = getattr(tce, fn)(*map(_t, args))
    if fn == "class_usage":
        want, got = (want,), (got,)
    names = {"class_color_stats": ("mu", "sigma"),
             "class_color_cov": ("mu", "cov"),
             "class_channel_quantiles": ("quantiles", "mass"),
             "class_usage": ("usage",)}[fn]
    ref = _f64_stats(x, g)
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **STAT_TOL)
        if name in ref:  # no farther from the float64 value than JAX
            err_port = np.abs(a.numpy() - ref[name]).max()
            err_jax = np.abs(b - ref[name]).max()
            assert err_port <= err_jax + 1e-7, (name, err_port, err_jax)


def _u8_budget(got, want, what):
    """Within 1 u8 on all but 1e-3 of the bytes, at most 2; the message
    names the first byte that differs."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == np.uint8 and got.shape == want.shape, what
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    first = np.argwhere(d > 0)[:1].tolist()
    msg = (f"{what}: max {d.max()}, share > 1 {(d > 1).mean():.2e}, "
           f"first differing byte {first}")
    assert d.max() <= 2 and (d > 1).mean() <= 1e-3, msg
    return d


TRANSFERS = [("diag", "hsd"), ("full", "hsd"), ("quantile", "hsd"),
             ("quantile", "rgb"), ("full-quantile", "hsd"),
             ("full-quantile", "rgb")]


def _transfer(mod, name, space, d, perm, conv):
    s = d[space]
    x, g = conv(s["x_s"]), conv(d["g_s"])
    p = None if perm is None else conv(perm)
    if name == "diag":
        return mod.image_dist_transform(x, g, *map(conv, s["stats_s"]),
                                        *map(conv, s["stats_t"]), perm=p)
    if name == "full":
        return mod.image_dist_transform_full(x, g, *map(conv, s["cov_s"]),
                                             *map(conv, s["cov_t"]), perm=p)
    if name == "quantile":
        return mod.image_dist_transform_quantile(
            x, g, conv(s["q_s"]), conv(s["q_t"]), perm=p, space=space)
    return mod.image_dist_transform_full_quantile(
        x, g, *map(conv, s["cov_s"]), *map(conv, s["cov_t"]),
        conv(s["q_t"]), perm=p, space=space)


@pytest.mark.parametrize("perm", [None, PERM], ids=["k_to_k", "perm"])
@pytest.mark.parametrize("name,space", TRANSFERS)
def test_transfers_match_jax(data, name, space, perm):
    want = _transfer(jce, name, space, data, perm, np.asarray)
    got = _transfer(tce, name, space, data, perm, _t)
    _u8_budget(got, want, f"{name} in {space}")


def test_transfer_rejects_an_unknown_space(data):
    s = data["hsd"]
    with pytest.raises(ValueError):
        tce.image_dist_transform_quantile(_t(s["x_s"]), _t(data["g_s"]),
                                          _t(s["q_s"]), _t(s["q_t"]),
                                          space="lab")


def test_interp_is_jnp_interp_bit_for_bit():
    """Repeated knots (flat runs, as an empty class's cumulative weights
    give), points outside the range, points on a knot; batched rows."""
    rng = np.random.default_rng(0)
    xp = np.array([0.0, 0.1, 0.1, 0.1, 0.25, 0.5, 0.5, 1.0], np.float32)
    fp = rng.random(xp.shape).astype(np.float32)
    x = np.concatenate([xp, [-0.5, -1e-8, 1.0 + 1e-7, 2.0],
                        rng.uniform(-0.2, 1.2, 400)]).astype(np.float32)
    want = np.asarray(jnp.interp(x, xp, fp))
    got = tce._interp(_t(x), _t(xp), _t(fp)).numpy()
    assert got.tobytes() == want.tobytes()
    flat = np.full(5, 0.3, np.float32)  # every knot equal
    want = np.asarray(jnp.interp(x, flat, fp[:5]))
    assert tce._interp(_t(x), _t(flat), _t(fp[:5])).numpy().tobytes() == \
        want.tobytes()
    rows = np.sort(rng.random((3, 33)).astype(np.float32), axis=-1)
    frows = rng.random((3, 33)).astype(np.float32)
    xs = rng.uniform(-0.1, 1.1, (3, 200)).astype(np.float32)
    want = np.stack([np.asarray(jnp.interp(xs[i], rows[i], frows[i]))
                     for i in range(3)])
    got = tce._interp(_t(xs), _t(rows), _t(frows)).numpy()
    assert got.tobytes() == want.tobytes()


def test_spd_power_symmetrizes_its_input():
    """A covariance that is symmetric only up to rounding: ``jnp.linalg.
    eigh`` symmetrizes it, ``torch.linalg.eigh`` alone would read one
    triangle."""
    rng = np.random.default_rng(1)
    A = rng.normal(size=(3, 3, 3)).astype(np.float32)
    M = (A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3)).astype(np.float32)
    M[:, 0, 1] += 1e-3 * np.abs(M[:, 0, 1])  # off by more than rounding
    for p in (0.5, -0.5):
        want = np.asarray(jce._spd_power(jnp.asarray(M), p))
        got = tce._spd_power(_t(M), p).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        lower = torch.linalg.eigh(_t(M).double())
        plain = ((lower[1] * torch.clamp_min(lower[0], 1e-8)[..., None, :]
                  ** p) @ lower[1].transpose(-1, -2)).float().numpy()
        assert np.abs(plain - want).max() > 10 * np.abs(got - want).max()


def test_monge_maps_match_jax(data):
    cs, ct = data["hsd"]["cov_s"][1], data["hsd"]["cov_t"][1]
    want = np.asarray(jce.monge_maps(cs, ct))
    got = tce.monge_maps(_t(cs), _t(ct)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("u_s,u_t", [
    ([0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]),
    ([0.3, 0.2, 0.3, 0.2], [0.2, 0.2, 0.3, 0.3]),
    ([0.1, 0.2, 0.3, 0.4], [0.4, 0.3, 0.2, 0.1]),
    ([0.5, 0.0, 0.5, 0.0], [0.0, 0.0, 1.0, 0.0]),
])
def test_match_classes_by_usage_with_ties(u_s, u_t):
    u_s, u_t = np.float32(u_s), np.float32(u_t)
    want = np.asarray(jce.match_classes_by_usage(u_s, u_t))
    got = tce.match_classes_by_usage(_t(u_s), _t(u_t))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_nmi_and_its_aggregates_match_jax(data):
    """Per image (and batched) within 1e-5; ``nmi_per_class`` on the same
    uint8 images equal; the SD/CV aggregates equal."""
    rgb = np.asarray(_transfer(jce, "diag", "hsd", data, None, np.asarray))
    mask = np.asarray(jnp.mean(rgb.astype(np.float32), -1) < 220.0)
    want = np.array([float(jce.nmi(rgb[i], mask[i]))
                     for i in range(len(rgb))])
    got = tce.nmi(_t(rgb), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert abs(float(tce.nmi(_t(rgb[0]), _t(mask[0]))) - want[0]) <= 1e-5
    g = data["g_s"]
    cls_w = jce.nmi_per_class(rgb, g)
    cls_t = tce.nmi_per_class(rgb, g)
    np.testing.assert_array_equal(cls_t, cls_w)
    assert np.isnan(cls_t[:, K - 1]).all()  # the empty class: skipped
    assert tce.nmi_sd_cv(got) == pytest.approx(jce.nmi_sd_cv(want),
                                               abs=1e-5)
    assert tce.class_nmi_sd_cv(cls_t)[:2] == jce.class_nmi_sd_cv(cls_w)[:2]
