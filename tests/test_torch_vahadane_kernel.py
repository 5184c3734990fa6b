"""The fused Vahadane kernels' and the fixed-matrix apply kernel's plain
PyTorch versions and their wrappers.

On the CPU the wrappers run the plain versions, which are held to the JAX
Pallas kernels in interpret mode:

* fit+transform (K2): at most 1 uint8 step apart, at least 99.9%
  identical; byte for byte on an all-white tile;
* dictionary (K8): stain matrices at atol 1e-5 (the two differ only in
  float32 sum order), NaN for an empty mask;
* fixed-matrix apply (K9): at most 1 uint8 step, at least 99.9% identical,

and to the port's functional path within the budget that
``tests/test_vahadane_fused.py`` sets for the TPU kernel. The CUDA
kernels themselves are tested in ``test_torch_vahadane_cuda.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stainlib_tpu.kernels import fused_stain as jax_fs  # noqa: E402
from stainlib_tpu.kernels import vahadane_fused as jax_vf  # noqa: E402
from stainlib_tpu.normalization import extractive as jax_ex  # noqa: E402
from stainlib_tpu_torch.kernels import fused_stain as fs  # noqa: E402
from stainlib_tpu_torch.kernels import vahadane_fused as vf  # noqa: E402
from stainlib_tpu_torch.normalization import extractive  # noqa: E402
from tests.synth import he_batch, he_patch  # noqa: E402

VFAST = dict(fit_stride=2, num_iters=8, n_bisect=10)


def _diff(got, want):
    return np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))


def _target(h, w, seed=90):
    p = jax_ex.fit(jnp.asarray(he_patch(h, w, seed=seed)), method="vahadane")
    return np.array(p.stain_matrix_target), np.array(p.max_c_target)


@pytest.mark.parametrize("shape,kw", [((32, 64), {}), ((128, 128), VFAST)],
                         ids=["32x64-defaults", "128-fs2-it8-nb10"])
def test_plain_k2_matches_jax_kernel(shape, kw):
    h, w = shape
    M, mc = _target(h, w)
    batch = he_batch(2, h, w, seed=95)
    want = np.asarray(jax_vf.vahadane_normalize(jnp.asarray(batch), M, mc,
                                                interpret=True, **kw))
    got = vf.vahadane_normalize(torch.from_numpy(batch), M, mc, **kw).numpy()
    d = _diff(got, want)
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(),
                                                      (d == 0).mean())


def test_plain_k8_and_k9_match_jax_kernels():
    """K8 on tissue tiles and on an empty mask; K9 given the JAX kernel's
    own source matrices."""
    batch = he_batch(2, 32, 64, seed=95)
    tiles = np.concatenate([batch, np.full((1, 32, 64, 3), 255, np.uint8)])
    jplanar = jax_fs.to_planar(jnp.asarray(tiles))
    tplanar = fs.to_planar(torch.from_numpy(tiles)).contiguous()
    want = np.asarray(jax_vf.vahadane_stain_matrix_planar(jplanar,
                                                          interpret=True))
    got = vf.vahadane_stain_matrix_planar(tplanar).numpy()
    assert np.isnan(want[2]).all() and np.isnan(got[2]).all()
    np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-5)

    M, mc = _target(32, 64)
    M_src = want[:2].copy()
    want = np.asarray(jax_fs.fused_normalize_planar(
        jplanar[:2], M_src, M, mc, interpret=True))
    got = fs.fused_normalize_planar(tplanar[:2], M_src, M, mc).numpy()
    d = _diff(got, want)
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(),
                                                      (d == 0).mean())


def test_plain_k2_white_tile_is_byte_identical_to_jax():
    """An empty mask: the tile passes through the JAX kernel's steps to the
    same bytes (white stays white)."""
    M, mc = _target(32, 64)
    white = np.full((1, 32, 128, 3), 255, np.uint8)
    want = np.asarray(jax_vf.vahadane_normalize(jnp.asarray(white), M, mc,
                                                interpret=True))
    got = vf.vahadane_normalize(torch.from_numpy(white), M, mc).numpy()
    assert (got == want).all() and (got == 255).all()


def test_plain_k2_against_functional_path():
    """The TPU kernel's budget (``tests/test_vahadane_fused.py:40-42``,
    ``:122-124``): <=1 u8 on >99% and max <=4 at fs=1; <=3 on >99% and max
    <=5 at fs=2, 128^2; on those tests' tiles (the fs=2 budget holds for
    them, not for every 128^2 tile: below 256^2 the API keeps fs=1)."""
    for (h, w), kw, seed, step, top in (
            ((32, 64), {}, 96, 1, 4),
            ((128, 128), dict(fit_stride=2), 70, 3, 5)):
        params = extractive.fit(torch.from_numpy(he_patch(h, w, seed=seed)),
                                method="vahadane")
        batch = torch.from_numpy(he_batch(2, h, w, seed=seed + 1))
        want = extractive.transform(params, batch, method="vahadane")
        got = vf.vahadane_normalize(batch, params.stain_matrix_target,
                                    params.max_c_target, **kw)
        d = _diff(got, want)
        assert (d <= step).mean() > 0.99 and d.max() <= top, (d.max(), kw)


def test_plain_two_kernel_pipeline_matches_single_kernel():
    """``vahadane_normalize_planar_2k`` (K8 then K9) against K2, within 1
    u8 (``tests/test_vahadane_fused.py:77-95``)."""
    params = extractive.fit(torch.from_numpy(he_patch(32, 64, seed=98)),
                            method="vahadane")
    planar = fs.to_planar(torch.from_numpy(he_batch(2, 32, 64, seed=99)))
    one = vf.vahadane_normalize_planar(planar, params.stain_matrix_target,
                                       params.max_c_target)
    two = vf.vahadane_normalize_planar_2k(planar, params.stain_matrix_target,
                                          params.max_c_target)
    assert _diff(one, two).max() <= 1


def test_wrappers_on_cpu_tensors():
    """A CPU tensor takes the plain version (no launch); the planar and
    interleaved entries agree; malformed input raises."""
    M, mc = _target(32, 64)
    rgb = torch.from_numpy(he_batch(2, 32, 64, seed=96))
    planar = fs.to_planar(rgb).contiguous()
    before = (vf.launches, vf.dict_launches, fs.launches)
    out = vf.vahadane_normalize(rgb, M, mc)
    assert out.dtype == torch.uint8 and out.shape == rgb.shape
    assert torch.equal(
        fs.from_planar(vf.vahadane_normalize_planar(planar, M, mc), 32, 64),
        out)
    assert torch.equal(vf.vahadane_normalize(rgb, np.broadcast_to(
        M, (2, 2, 3)), mc), out)
    Ms = vf.vahadane_stain_matrix_planar(planar)
    assert Ms.shape == (2, 2, 3) and Ms.dtype == torch.float32
    k9 = fs.fused_normalize(rgb, Ms, M, mc)
    assert torch.equal(
        fs.from_planar(fs.fused_normalize_planar(planar, Ms, M, mc), 32, 64),
        k9)
    assert (vf.launches, vf.dict_launches, fs.launches) == before
    with pytest.raises(TypeError):
        vf.vahadane_normalize(rgb.float(), M, mc)
    with pytest.raises(ValueError):
        vf.vahadane_normalize(rgb[:, :, :3], M, mc)  # 32*3 pixels
    with pytest.raises(ValueError):
        vf.vahadane_stain_matrix_planar(rgb)
    with pytest.raises(ValueError):
        vf.vahadane_normalize_planar(planar, M, mc, fit_stride=3)
    with pytest.raises(TypeError):
        fs.fused_normalize_planar(planar.float(), Ms, M, mc)
    with pytest.raises(ValueError):
        fs.fused_normalize(rgb[:, :, :3], Ms, M, mc)


def test_od_lasso_table_is_the_tpu_kernels_expression():
    """K9's OD row is ``_od_lasso``'s float32 expression, which differs from
    the Macenko/Vahadane kernels' ``_od_and_mask`` OD in the last bit."""
    from stainlib_tpu_torch.kernels.macenko_fused import _tables

    u = jnp.arange(256, dtype=jnp.float32)
    want = np.asarray(jnp.maximum(
        -jnp.log(jnp.maximum(u, 1.0) * (1.0 / 255.0)), 1e-6))
    got = fs._od_lasso_table("cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    assert (got != _tables("cpu")[0].numpy()).sum() > 0
