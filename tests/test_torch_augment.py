"""The port's augmentation package against the JAX package, on the CPU.

Inputs are synthetic H&E tiles from a seed; ``jax.random`` bits cannot be
reproduced with a ``torch.Generator``, so each test recomputes the JAX
function's own draws from its key and feeds them to the port's private
``_..._apply``. Tolerances:

* color-space ops (HED both ways, gray, ``od_to_rgb``): rtol 1e-5, with
  atol 1e-6 for HED values near zero (the 3x3 contraction cancels there);
* every uint8 augmentation: at most 1 uint8 step, at least 99.9% of bytes
  equal (the two packages round a few float32 expressions differently);
* stain matrices of the fit: atol 1e-5 (float64 vs float32 sums at 64^2).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import stainlib_tpu_torch as st  # noqa: E402
from stainlib_tpu.augmentation import functional as JF  # noqa: E402
from stainlib_tpu.augmentation import geometric as JG  # noqa: E402
from stainlib_tpu.augmentation import hsv as JH  # noqa: E402
from stainlib_tpu.ops import colorspace as JC  # noqa: E402
from stainlib_tpu_torch import convert  # noqa: E402
from stainlib_tpu_torch.augmentation import functional as F  # noqa: E402
from stainlib_tpu_torch.augmentation import geometric as G  # noqa: E402
from stainlib_tpu_torch.augmentation import hsv as H  # noqa: E402
from stainlib_tpu_torch.exceptions import (  # noqa: E402
    InvalidRangeError,
    TissueMaskException,
)
from stainlib_tpu_torch.kernels import macenko_fused as mf  # noqa: E402
from stainlib_tpu_torch.ops import colorspace as C  # noqa: E402
from tests.synth import he_batch, he_patch  # noqa: E402

KEY = jax.random.PRNGKey(42)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close_u8(got, want):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(),
                                                      (d == 0).mean())


# ---- color-space ops --------------------------------------------------------


def test_hed_gray_od_ops_match_jax():
    x = he_batch(2, 32, 64, seed=5).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(256), np.arange(0, 256, 5),
                                np.arange(0, 256, 17), indexing="ij"),
                    -1).reshape(-1, 3).astype(np.float32)
    for inp in (x, grid):
        hed = np.asarray(JC.rgb_to_hed(jnp.asarray(inp)))
        np.testing.assert_allclose(C.rgb_to_hed(_t(inp)).numpy(), hed,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(C.hed_to_rgb(_t(hed)).numpy(),
                                   np.asarray(JC.hed_to_rgb(jnp.asarray(hed))),
                                   rtol=1e-5)
        np.testing.assert_allclose(C.rgb_to_gray(_t(inp)).numpy(),
                                   np.asarray(JC.rgb_to_gray(jnp.asarray(inp))),
                                   rtol=1e-5)
    od = np.random.default_rng(0).uniform(-0.5, 4.0, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(C.od_to_rgb(_t(od)).numpy(),
                               np.asarray(JC.od_to_rgb(jnp.asarray(od))),
                               rtol=1e-5)


def test_contractions_are_fixed_order_multiply_adds():
    """The 3x3 contractions are products and sums rounded left to right,
    the same on every device (no matrix product)."""
    x = _t(he_batch(1, 16, 16, seed=6).astype(np.float32) / 255.0)
    m = C._RGB2XYZ.T
    want = torch.stack([x[..., 0] * float(m[0, k]) + x[..., 1] * float(m[1, k])
                        + x[..., 2] * float(m[2, k]) for k in range(3)], -1)
    assert torch.equal(C._contract(x, m), want)
    assert torch.equal(C._contract(x, C._GRAY_WEIGHTS),
                       x[..., 0] * float(C._GRAY_WEIGHTS[0])
                       + x[..., 1] * float(C._GRAY_WEIGHTS[1])
                       + x[..., 2] * float(C._GRAY_WEIGHTS[2]))


# ---- uint8 augmentations fed JAX's draws ----------------------------------


@pytest.mark.parametrize("thresh", [0.03, 0.1, 1.0])
def test_hed_jitter_matches_jax(thresh):
    batch = he_batch(3, 32, 32, seed=60)
    preset = JF.hed_preset(thresh)
    want = JF.hed_jitter(jnp.asarray(batch), KEY, **preset)
    k_s, k_b = jax.random.split(KEY)
    names = ("haematoxylin", "eosin", "dab")
    sig = JF._uniform(k_s, (3,), [preset[f"{n}_sigma_range"] for n in names],
                      0.0)
    bia = JF._uniform(k_b, (3,), [preset[f"{n}_bias_range"] for n in names],
                      0.0)
    got = F.hed_jitter_apply(_t(batch), _t(sig), _t(bia),
                             preset["cutoff_range"])
    _close_u8(got, want)


def test_hed_cutoff_passes_white_through():
    white = torch.full((2, 16, 16, 3), 255, dtype=torch.uint8)
    g = torch.Generator().manual_seed(0)
    assert (F.hed_strong(white, g) == 255).all()


def test_grayscale_matches_jax():
    batch = he_batch(2, 24, 24, seed=62)
    want = JF.grayscale_augment(jnp.asarray(batch), KEY)
    k_a, k_b = jax.random.split(KEY)
    alpha = jax.random.uniform(k_a, (2,), jnp.float32, 0.8, 1.2)
    beta = jax.random.uniform(k_b, (2,), jnp.float32, -0.2, 0.2)
    got = F._grayscale_apply(_t(batch), _t(alpha), _t(beta))
    _close_u8(got, want)
    assert (got[..., 0] == got[..., 2]).all()


def test_rgb_jitter_matches_jax():
    batch = he_batch(2, 16, 16, seed=64)
    want = JF.rgb_jitter(jnp.asarray(batch), KEY)
    k_a, k_b = jax.random.split(KEY)
    a = jax.random.uniform(k_a, (2, 3), jnp.float32, 0.9, 1.1)
    b = jax.random.uniform(k_b, (2, 3), jnp.float32, -10.0, 10.0)
    got = F._rgb_jitter_apply(_t(batch), _t(a), _t(b))
    _close_u8(got, want)
    assert got.min() <= 2 and got.max() >= 250


@pytest.mark.parametrize("preset", [(0.05, 0.1, 0.1), (0.5, 0.5, 0.35)],
                         ids=["light", "strong"])
def test_hsv_jitter_matches_jax(preset):
    batch = he_batch(2, 32, 32, seed=66)
    want = JH.hsv_jitter(jnp.asarray(batch), KEY, *preset)
    hue, sat, val = preset
    k_h, k_s, k_v = jax.random.split(KEY, 3)
    dh = jax.random.uniform(k_h, (2,), jnp.float32, -hue, hue)
    ds = jax.random.uniform(k_s, (2,), jnp.float32, 1 - sat, 1 + sat)
    dv = jax.random.uniform(k_v, (2,), jnp.float32, 1 - val, 1 + val)
    got = H._hsv_jitter_apply(_t(batch), _t(dh), _t(ds), _t(dv))
    _close_u8(got, want)


def _jax_geometric_draws(key, n, rot, wsh, hsh, shear, zoom, ch):
    """The per-sample draws of JAX ``random_geometric``
    (``geometric.py:109-126``, ``_affine_params`` ``:28-42``)."""
    out = {k: [] for k in ("theta", "tx", "ty", "shear", "zoom", "shift",
                           "hf", "vf")}
    for k in jax.random.split(key, n):
        k_aff, k_ch, k_hf, k_vf = jax.random.split(k, 4)
        ks = jax.random.split(k_aff, 5)
        out["theta"].append(jax.random.uniform(ks[0], (), minval=-rot,
                                               maxval=rot))
        out["tx"].append(jax.random.uniform(ks[1], (), minval=-hsh,
                                            maxval=hsh))
        out["ty"].append(jax.random.uniform(ks[2], (), minval=-wsh,
                                            maxval=wsh))
        out["shear"].append(jax.random.uniform(ks[3], (), minval=-shear,
                                               maxval=shear))
        out["zoom"].append(jax.random.uniform(ks[4], (2,), minval=1 - zoom,
                                              maxval=1 + zoom))
        out["shift"].append(jax.random.uniform(k_ch, (3,), minval=-ch,
                                               maxval=ch))
        out["hf"].append(jax.random.bernoulli(k_hf))
        out["vf"].append(jax.random.bernoulli(k_vf))
    return {k: _t(np.stack([np.asarray(x) for x in v]))
            for k, v in out.items()}


def test_random_geometric_matches_jax():
    batch = he_batch(3, 32, 40, seed=67).astype(np.float32)
    kw = dict(rotation_range=30.0, width_shift_range=0.1,
              height_shift_range=0.1, shear_range=10.0, zoom_range=0.2,
              channel_shift_range=5.0, horizontal_flip=True,
              vertical_flip=True)
    want = np.asarray(JG.random_geometric(jnp.asarray(batch), KEY, **kw))
    d = _jax_geometric_draws(KEY, 3, 30.0, 0.1, 0.1, 10.0, 0.2, 5.0)
    m = G._affine_matrices(32, 40, d["theta"], d["tx"], d["ty"], d["shear"],
                           d["zoom"])
    got = G._random_geometric_apply(_t(batch), m, d["shift"], d["hf"],
                                    d["vf"]).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    _close_u8(np.clip(got, 0, 255).astype(np.uint8),
              np.clip(want, 0, 255).astype(np.uint8))
    assert np.abs(got - want).mean() < 1e-2, np.abs(got - want).mean()


def test_flips_rots_and_crops_match_jax():
    batch = he_batch(4, 24, 24, seed=68)
    codes = jax.random.randint(KEY, (4,), 0, 8)
    want = np.asarray(JG.random_flips_rots(jnp.asarray(batch), KEY))
    got = G._random_flips_rots_apply(_t(batch), _t(codes))
    assert (got.numpy() == want).all()
    assert (G.center_crop(_t(batch), 16).numpy()
            == np.asarray(JG.center_crop(jnp.asarray(batch), 16))).all()
    k1, k2 = jax.random.split(KEY)
    r0 = jax.random.randint(k1, (4,), 0, 24 - 10 + 1)
    c0 = jax.random.randint(k2, (4,), 0, 24 - 10 + 1)
    want = np.asarray(JG.random_crop(jnp.asarray(batch), KEY, 10))
    got = G._random_crop_apply(_t(batch), _t(r0), _t(c0), 10)
    assert (got.numpy() == want).all()
    g = torch.Generator().manual_seed(1)
    assert G.random_crop(_t(batch), g, 10).shape == (4, 10, 10, 3)
    assert G.random_flips_rots(_t(batch), g).shape == batch.shape


# ---- stain augmentation ----------------------------------------------------


@pytest.mark.parametrize("method", ["macenko", "vahadane"])
def test_stain_augment_fit_and_pop_match_jax(method):
    img = he_patch(48, 48, seed=63)
    jp = JF.stain_augment_fit(jnp.asarray(img), method=method)
    tp = F.stain_augment_fit(_t(img), method=method)
    np.testing.assert_allclose(tp.stain_matrix.numpy(),
                               np.asarray(jp.stain_matrix), atol=1e-5)
    assert (tp.mask.numpy() == np.asarray(jp.mask)).all()
    # Pop from the same (JAX) state, with JAX's draws.
    params = convert.stain_augment_params_from_jax(
        np.asarray(jp.stain_matrix), np.asarray(jp.concentrations),
        np.asarray(jp.mask), "cpu")
    for key, bg in ((KEY, False), (jax.random.PRNGKey(1), True)):
        want = JF.stain_augment_pop(jp, key, 0.3, 0.2, bg)
        k_a, k_b = jax.random.split(key)
        alpha = jax.random.uniform(k_a, (2,), jnp.float32, 0.7, 1.3)
        beta = jax.random.uniform(k_b, (2,), jnp.float32, -0.2, 0.2)
        got = F._stain_augment_pop_apply(params, _t(alpha), _t(beta), bg)
        _close_u8(got, want)


def test_fused_pop_from_jax_state_matches_jax():
    """The fit-once/pop-many state carried over from JAX; one pop is K7
    (its plain version here) with JAX's draws."""
    img = he_batch(2, 64, 128, seed=23)
    state = JF.stain_augment_fit_fused(img, method="macenko", interpret=True)
    key = jax.random.PRNGKey(5)
    want = JF.stain_augment_pop_fused(state, key, interpret=True)
    k_a, k_b = jax.random.split(key)
    alpha = jax.random.uniform(k_a, (2, 2), jnp.float32, 0.8, 1.2)
    beta = jax.random.uniform(k_b, (2, 2), jnp.float32, -0.2, 0.2)
    port = convert.fused_augment_state_from_jax(
        np.asarray(state.planar), np.asarray(state.stain_matrix), state.h,
        state.w, "cpu")
    got = F._stain_augment_pop_fused_apply(port, _t(alpha), _t(beta))
    _close_u8(got, want)
    # The port's own fused fit holds the same planar tiles and matrices.
    mine = F.stain_augment_fit_fused(_t(img), method="macenko")
    assert torch.equal(mine.planar, port.planar)
    np.testing.assert_allclose(mine.stain_matrix.numpy(),
                               port.stain_matrix.numpy(), atol=1e-5)


def test_stain_augment_routes_functional_on_cpu():
    """On the CPU every input takes fit + pop, with the draws of
    ``stain_augment_pop`` for the same generator state; no kernel runs."""
    batch = _t(he_batch(2, 32, 64, seed=210))
    before = (mf.aug_launches, mf.augment_launches)
    got = F.stain_augment(batch, torch.Generator().manual_seed(3))
    want = F.stain_augment_pop(F.stain_augment_fit(batch),
                               torch.Generator().manual_seed(3))
    assert torch.equal(got, want) and got.dtype == torch.uint8
    assert (mf.aug_launches, mf.augment_launches) == before
    one = F.stain_augment(batch[0], torch.Generator().manual_seed(4),
                          method="vahadane")
    assert one.shape == batch[0].shape


def test_draws_follow_the_generator():
    """Same seed, same draws; the draws are made on the generator's device
    and moved to the images'."""
    batch = _t(he_batch(2, 16, 16, seed=64))
    for fn in (F.hed_light, F.grayscale_augment, F.rgb_jitter, H.hsv_light):
        a = fn(batch, torch.Generator().manual_seed(9))
        b = fn(batch, torch.Generator().manual_seed(9))
        c = fn(batch, torch.Generator().manual_seed(10))
        assert torch.equal(a, b) and not torch.equal(a, c), fn.__name__
    alpha, beta = F._stain_draws(torch.Generator().manual_seed(1), (5,),
                                 0.2, 0.1, "cpu")
    assert alpha.shape == (5, 2) and (alpha - 1).abs().max() <= 0.2
    assert beta.abs().max() <= 0.1


# ---- drop-in augmenter classes ---------------------------------------------


def test_invalid_range_raises():
    with pytest.raises(InvalidRangeError):
        st.HedColorAugmenter((-2.0, 0.1), None, None, None, None, None, None,
                             device="cpu")
    with pytest.raises(InvalidRangeError):
        st.HedColorAugmenter(None, None, None, None, None, None, (0.5, 0.2),
                             device="cpu")
    with pytest.raises(Exception, match="not recognized"):
        st.StainAugmentor("bogus", device="cpu")


def test_hed_class_contract():
    aug = st.HedColorAugmenter(
        haematoxylin_sigma_range=None, haematoxylin_bias_range=None,
        eosin_sigma_range=(-0.1, 0.1), eosin_bias_range=(-0.1, 0.1),
        dab_sigma_range=None, dab_bias_range=None, cutoff_range=None,
        device="cpu")
    assert aug._sigmas[0] == 0.0 and aug._biases[0] == 0.0
    img = he_patch(32, 32, seed=65)
    out0 = aug.transform(img)
    assert (out0 == aug.transform(img)).all()  # deterministic before randomize
    aug.randomize()
    # A None sigma range randomizes to exactly 1.0, a None bias to 0.0
    # (augmenter.py:333-344).
    assert aug._sigmas[0] == 1.0 and aug._sigmas[2] == 1.0
    assert aug._biases[0] == 0.0 and aug._biases[2] == 0.0
    assert -0.1 <= aug._sigmas[1] <= 0.1
    light = st.HedLightColorAugmenter(seed=3, device="cpu")
    light.randomize()
    out1 = light.transform(img)
    assert out1.dtype == np.uint8 and out1.shape == img.shape
    light.randomize()
    assert (out1 != light.transform(img)).any()
    f = st.HedLighterColorAugmenter(seed=4, device="cpu").transform(
        img.astype(np.float64) / 255.0)
    assert f.dtype.kind == "f" and f.max() <= 1.0


def test_grayscale_and_stain_augmentor_contracts():
    img = he_patch(32, 32, seed=68)
    white = np.full((16, 16, 3), 255, np.uint8)
    gray = st.GrayscaleAugmentor(seed=5, device="cpu")
    with pytest.raises(TissueMaskException):
        gray.fit(white)
    gray.fit(img)
    a, b = gray.pop(), gray.pop()
    assert a.dtype == np.uint8 and (a[..., 0] == a[..., 1]).all()
    assert (a != b).any()  # fresh draws per pop

    aug = st.StainAugmentor("macenko", seed=6, device="cpu")
    with pytest.raises(RuntimeError):
        aug.pop()  # pop before fit
    with pytest.raises(TissueMaskException):
        aug.fit(white)
    aug.fit(img)
    assert aug.stain_matrix.shape == (2, 3)
    assert aug.source_concentrations.shape == (32 * 32, 2)
    assert aug._fused_state is None  # the CPU keeps the functional pop
    a, b = aug.pop(), aug.pop()
    assert a.shape == img.shape and a.dtype == np.uint8 and (a != b).any()
    bg = st.StainAugmentor("vahadane", sigma1=0.3, sigma2=0.1,
                           augment_background=True, seed=9, device="cpu")
    bg.fit(img)
    assert bg.pop().shape == img.shape


def test_cuda_default_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.StainAugmentor("macenko")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.HedLightColorAugmenter()
