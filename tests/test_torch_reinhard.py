"""The port's Reinhard path (``ops/percentile.mean_std``,
``normalization/reinhard.py``, the plain version of kernel K5 and the
drop-in ``ReinhardStainNormalizer``) against the JAX package and the cv2
golden on the CPU.

Same numpy images on both sides (``tests/synth.py``). Tolerances:

* ``mean_std`` / ``masked_mean``: rtol and atol 1e-5 (float32 sums in
  another order; the std's E[x^2] - mu^2 cancels).
* fit: means and stds atol 2e-4 from JAX (float32 means over 65k pixels at
  256^2; 1e-5 at 64^2) and atol 0.05 from the cv2 golden, whose 8-bit LAB
  conversion JAX's own fit is 0.036 away from.
* transform with the same fitted state: at most 1 uint8 step from JAX, on
  under 1% of the bytes. The per-image LAB means are float32 sums in
  another order (2e-4 apart at 64^2), and the merge-back floor turns that
  into a 1 u8 step on up to 0.5% of the bytes. ΔE < 1.0 against the cv2
  golden, as ``tests/test_normalization.py`` asks of JAX.
* plain K5: at most 1 uint8 step from the JAX kernel in interpret mode, on
  under 0.1% of the bytes, and within ``tests/test_reinhard_fused.py``'s
  budget of the functional path (<=1 on >99%, max <=3).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import stainlib_tpu as jsl  # noqa: E402
import stainlib_tpu_torch as tsl  # noqa: E402
from stainlib_tpu.kernels import reinhard_fused as jax_k  # noqa: E402
from stainlib_tpu.normalization import reinhard as jax_rh  # noqa: E402
from stainlib_tpu.ops.percentile import masked_mean as jax_masked_mean  # noqa: E402
from stainlib_tpu.ops.percentile import mean_std as jax_mean_std  # noqa: E402
from stainlib_tpu_torch.convert import reinhard_params_from_jax  # noqa: E402
from stainlib_tpu_torch.kernels import fused_stain as fs  # noqa: E402
from stainlib_tpu_torch.kernels import reinhard_fused as rf  # noqa: E402
from stainlib_tpu_torch.normalization import reinhard  # noqa: E402
from stainlib_tpu_torch.ops.percentile import masked_mean, mean_std  # noqa: E402
from tests import cpu_reference as ref  # noqa: E402
from tests.synth import he_batch, he_patch  # noqa: E402

WHITE = np.full((16, 16, 3), 255, np.uint8)


def _diff(got, want):
    return np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))


def _u8_close(got, want, share=1e-3):
    d = _diff(got, want)
    assert d.max() <= 1 and (d > 0).mean() < share, (d.max(), (d > 0).mean())


def _params(seed, side=64):
    jp = jax_rh.fit(jnp.asarray(he_patch(side, side, seed=seed)))
    return jp, reinhard_params_from_jax(np.asarray(jp.means),
                                        np.asarray(jp.stds), "cpu")


@pytest.mark.parametrize("axis", [None, (-3, -2), -1])
def test_mean_std_and_masked_mean_match_jax(axis):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 7, 3)) * 40 + 10).astype(np.float32)
    mask = rng.random((2, 5, 7, 3)) > 0.4
    for got, want in zip(mean_std(torch.from_numpy(x), axis=axis),
                         jax_mean_std(jnp.asarray(x), axis=axis)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(
        masked_mean(torch.from_numpy(x), torch.from_numpy(mask),
                               axis=axis).numpy(),
        np.asarray(jax_masked_mean(jnp.asarray(x), jnp.asarray(mask),
                                       axis=axis)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("side", [64, 256])
def test_fit_matches_jax_and_cv2(side):
    target = he_patch(side, side, seed=40)
    jp = jax_rh.fit(jnp.asarray(target))
    tp = reinhard.fit(torch.from_numpy(target))
    for got, want in ((tp.means, jp.means), (tp.stds, jp.stds)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-4)
    g_means, g_stds = ref.reinhard_fit(target)
    np.testing.assert_allclose(tp.means.numpy(), g_means, rtol=0, atol=0.05)
    np.testing.assert_allclose(tp.stds.numpy(), g_stds, rtol=0, atol=0.05)
    # The float path (quantize=False) as well.
    jf = jax_rh.fit(jnp.asarray(target), quantize=False)
    tf = reinhard.fit(torch.from_numpy(target), quantize=False)
    np.testing.assert_allclose(tf.means.numpy(), np.asarray(jf.means),
                               rtol=0, atol=2e-4)


@pytest.mark.parametrize("kw", [
    {}, dict(mask_background=True), dict(quantize=False),
    dict(brightness_divisor=200.0), dict(source_stats="jax"),
], ids=["default", "mask", "float", "divisor", "source_stats"])
def test_transform_matches_jax(kw):
    jp, tp = _params(40)
    src = he_batch(2, 64, 64, seed=41, background_frac=0.4)
    jkw, tkw = dict(kw), dict(kw)
    if "source_stats" in kw:  # another image's statistics, hoisted
        js, ts = _params(45)
        jkw["source_stats"], tkw["source_stats"] = js, ts
    want = jax_rh.transform(jp, jnp.asarray(src), **jkw)
    got = reinhard.transform(tp, torch.from_numpy(src), **tkw)
    assert got.dtype == torch.uint8 and got.shape == src.shape
    _u8_close(got, want, share=1e-2)
    if kw.get("mask_background"):
        assert got[:, :8].min() > 240  # background painted white


def test_transform_fidelity_vs_cv2():
    """``tests/test_normalization.py:11-19`` for the port."""
    target, src = he_patch(64, 64, seed=40), he_patch(64, 64, seed=41)
    tp = reinhard.fit(torch.from_numpy(target))
    got = reinhard.transform(tp, torch.from_numpy(src)).numpy()
    want = ref.reinhard_transform(src, *ref.reinhard_fit(target))
    assert ref.delta_e(got, want) < 1.0
    # Batched equals single.
    batch = he_batch(3, 64, 64, seed=43)
    out = reinhard.transform(tp, torch.from_numpy(batch))
    for i in range(3):
        assert torch.equal(out[i], reinhard.transform(
            tp, torch.from_numpy(batch[i])))


def test_plain_k5_matches_jax_kernel_and_functional():
    """At ``tests/test_reinhard_fused.py:27-35``'s 2x32x64 (interpret mode
    is slow)."""
    jp, tp = _params(112, side=32)
    batch = he_batch(2, 32, 64, seed=113)
    want = jax_k.reinhard_normalize(jnp.asarray(batch), jp.means, jp.stds,
                                    interpret=True)
    got = rf.reinhard_normalize(torch.from_numpy(batch), tp.means, tp.stds)
    _u8_close(got, want)
    d = _diff(got, reinhard.transform(tp, torch.from_numpy(batch)))
    assert (d <= 1).mean() > 0.99 and d.max() <= 3, (d.max(),
                                                     (d > 1).mean())


def test_plain_k5_at_256_against_functional():
    """256^2 tiles, where the percentile and the six sums run over 65k
    pixels; the same functional budget."""
    _, tp = _params(110, side=256)
    batch = torch.from_numpy(he_batch(4, 256, 256, seed=111))
    got = rf.reinhard_normalize(batch, tp.means, tp.stds)
    d = _diff(got, reinhard.transform(tp, batch))
    assert (d <= 1).mean() > 0.99 and d.max() <= 3, (d.max(),
                                                     (d > 1).mean())


def test_brightness_percentile_is_np_percentile():
    """The plain kernel's joint u8-grid percentile equals np.percentile
    over the tile's 3N bytes, including ties and a tile of one value."""
    rng = np.random.default_rng(3)
    tiles = rng.integers(0, 256, size=(3, 3, 1024)).astype(np.float32)
    tiles[1] = np.minimum(tiles[1], 30.0)  # heavy ties
    tiles[2] = 77.0
    for q in (90.0, 50.0, 99.9):
        got = rf._percentile_u8(torch.from_numpy(tiles), q).numpy()
        want = np.percentile(tiles.reshape(3, -1), q, axis=1)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_wrappers_on_cpu_tensors():
    _, tp = _params(90)
    rgb = torch.from_numpy(he_batch(2, 32, 64, seed=96))
    before = rf.launches
    out = rf.reinhard_normalize(rgb, tp.means, tp.stds)
    planar = rf.reinhard_normalize_planar(fs.to_planar(rgb).contiguous(),
                                          tp.means, tp.stds)
    assert rf.launches == before
    assert torch.equal(fs.from_planar(planar, 32, 64), out)
    one = rf.reinhard_normalize(rgb[1:], tp.means[None], tp.stds[None])
    assert torch.equal(one[0], out[1])
    with pytest.raises(TypeError):
        rf.reinhard_normalize(rgb.float(), tp.means, tp.stds)
    with pytest.raises(ValueError):
        rf.reinhard_normalize(rgb[:, :, :3], tp.means, tp.stds)


def test_dropin_class_matches_jax_and_raise_contract():
    """The JAX class's contract (``tests/test_api.py:38-75``)."""
    target, img = he_patch(48, 48, seed=52), he_patch(48, 48, seed=53)
    jn, tn = jsl.ReinhardStainNormalizer(), tsl.ReinhardStainNormalizer(
        device="cpu")
    assert tn.target_means == 0 and tn.target_stds == 0
    with pytest.raises(RuntimeError):
        tn.transform(img)
    jn.fit(target)
    tn.fit(target)
    assert np.asarray(tn.target_means).shape == (3,)
    np.testing.assert_allclose(tn.target_means, jn.target_means, atol=2e-4)
    np.testing.assert_allclose(tn.target_stds, jn.target_stds, atol=2e-4)
    for kw in ({}, dict(mask_background=True),
               dict(mask_background=True, luminosity_threshold=0.7)):
        out = tn.transform(img, **kw)
        assert out.dtype == np.uint8 and out.shape == img.shape
        _u8_close(out, jn.transform(img, **kw), share=1e-2)
    tn.transform(WHITE)  # no masking: the reference does not raise
    with pytest.raises(tsl.TissueMaskException):
        tn.transform(WHITE, mask_background=True)
    with pytest.raises(AssertionError):
        tn.transform(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(AssertionError):
        tn.fit(np.zeros((8, 8, 3), np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsl.ReinhardStainNormalizer()


def _apply_tables(x, scal, brightness_q=90.0):
    """K5's data flow on the card, in torch: after the percentile a
    per-tile table of the linearized brightness-floored byte; the packed
    LAB integers staged as three bytes per pixel, the sums taken from their
    unpacked floats; after the sums three per-tile 256-entry maps from a
    staged byte to (fy, y), A/500 and Bv/200; the apply pass gathers from
    them. Each table entry is the plain version's expression on the plain
    version's operands, so the bytes must equal ``rf._apply_ref``'s."""
    fdiv = rf.fdiv
    c = x.to(torch.float32)
    B, _, N = c.shape
    n = torch.tensor(float(N), dtype=torch.float32)
    p = torch.clamp_min(rf._percentile_u8(c, brightness_q), 1e-6)
    v = torch.arange(256, dtype=torch.float32)
    floor = torch.floor(torch.clamp(v[None] * 255.0 / p[:, None], 0.0, 255.0))
    blin = rf._lin_table(x.device)[floor.to(torch.long)]  # (B, 256)
    l = torch.gather(blin[:, None].expand(B, 3, 256), 2, x.to(torch.long))
    L, a, b = rf._rgb_to_lab_planes([l[:, 0], l[:, 1], l[:, 2]])
    staged = torch.stack([
        torch.clamp(torch.round(L * 2.55), 0.0, 255.0),
        torch.clamp(torch.round(a + 128.0), 0.0, 255.0),
        torch.clamp(torch.round(b + 128.0), 0.0, 255.0)], 1).to(torch.uint8)
    unpack = [fdiv(v, 2.55), v - 128.0, v - 128.0]  # byte -> quantized LAB
    maps = []
    for k, (pack, shift) in enumerate(((2.55, 0.0), (1.0, 128.0),
                                       (1.0, 128.0))):
        ch = unpack[k][staged[:, k].to(torch.long)]
        mu = rf._sum64(ch) / n
        sd = torch.sqrt(torch.clamp_min(rf._sum64(ch * ch) / n - mu * mu,
                                        1e-12))
        t = ((unpack[k][None] - mu[:, None])
             * (scal[:, 3 + k] / sd)[:, None] + scal[:, k, None])
        t = torch.floor(torch.clamp(t * pack + shift, 0.0, 255.0))
        maps.append(fdiv(t, 2.55) if k == 0 else t - 128.0)  # (B, 256)
    Lm = maps[0]
    fy_map = fdiv(Lm + 16.0, 116.0)
    y_map = torch.where(Lm > 903.3 * rf._DELTA, fy_map * fy_map * fy_map,
                        fdiv(Lm, 903.3))
    a_map, b_map = fdiv(maps[1], 500.0), fdiv(maps[2], 200.0)

    def take(table, k):
        return torch.gather(table, 1, staged[:, k].to(torch.long))

    fy, y = take(fy_map, 0), take(y_map, 0)
    fx, fz = fy + take(a_map, 1), fy - take(b_map, 2)

    def f_inv(ft):
        t3 = ft * ft * ft
        return torch.where(t3 > rf._DELTA, t3, fdiv(ft - 16.0 / 116.0, 7.787))

    xx, zz = f_inv(fx) * rf._WHITE[0], f_inv(fz) * rf._WHITE[2]
    inv24 = float(np.float32(1.0 / 2.4))

    def compress(c):
        c = torch.clamp_min(c, 0.0)
        srgb = torch.where(
            c <= 0.0031308, c * 12.92,
            1.055 * torch.exp(torch.log(torch.clamp_min(c, 1e-12)) * inv24)
            - 0.055)
        return torch.clamp(srgb, 0.0, 1.0) * 255.0

    rgb = [compress(r[0] * xx + r[1] * y + r[2] * zz) for r in rf._XYZ2RGB]
    return torch.stack([torch.clamp(torch.round(v), 0.0, 255.0).to(
        torch.uint8) for v in rgb], dim=1)


@pytest.mark.parametrize("side", [64, 128])
@pytest.mark.parametrize("seed", [60, 61, 62])
def test_k5_table_data_flow_equals_plain_version(side, seed):
    """Byte for byte on H&E tiles, an all-white tile and a dark tile."""
    _, tp = _params(44)
    tiles = he_batch(4, side, side, seed=seed)
    tiles[2] = 255
    tiles[3] = np.random.default_rng(seed).integers(0, 40, tiles[3].shape,
                                                    dtype=np.uint8)
    x = fs.to_planar(torch.from_numpy(tiles)).reshape(4, 3, -1)
    scal = rf._reinhard_scalars(tp.means, tp.stds, 4, x.device)
    assert torch.equal(_apply_tables(x, scal), rf._apply_ref(x, scal, 90.0))


def test_k5_functional_gap_is_the_references():
    """On ``chip_smoke.py``'s 2000x2300 slide (phase 43), K5 and the
    functional Reinhard path differ by 4 u8 on a few bytes of some tissue
    tiles, over ``tests/test_reinhard_fused.py:23-24``'s max of 3. The gap
    is the JAX package's own (its K5 in interpret mode against its
    functional path), and the port's K5 and functional path each give
    JAX's bytes there, so the port's gap is the reference's."""
    import chip_smoke as cs

    lv0 = cs.synth_level0(2000, 2300, 256, cs.SEED + 43)
    stain = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]])
    target = he_patch(256, 256, seed=cs.SEED + 40, background_frac=0.0,
                      stain=stain / np.linalg.norm(stain, axis=1,
                                                   keepdims=True))
    jp = jax_rh.fit(jnp.asarray(target))
    tp = reinhard_params_from_jax(np.asarray(jp.means), np.asarray(jp.stds),
                                  "cpu")
    tiles = np.stack([lv0[256:512, 1536:1792], lv0[256:512, 256:512]])
    jk = np.asarray(jax_k.reinhard_normalize(jnp.asarray(tiles), jp.means,
                                             jp.stds, interpret=True))
    jf = np.asarray(jax_rh.transform(jp, jnp.asarray(tiles)))
    tk = rf.reinhard_normalize(torch.from_numpy(tiles), *tp).numpy()
    tf = reinhard.transform(tp, torch.from_numpy(tiles)).numpy()
    assert np.array_equal(tk, jk) and np.array_equal(tf, jf)
    gap = np.abs(jk.astype(int) - jf)
    assert gap.max() == 4 and (gap > 1).mean() < 1e-4, (gap.max(),
                                                         (gap > 1).mean())
