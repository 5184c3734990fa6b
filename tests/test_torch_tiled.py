"""The port's tiled route for large fields (``extractive.transform_tiled``)
and its kernels' plain versions, against the JAX package on the CPU.

Same numpy tiles on both sides (``tests/synth.py``), at the sizes of
``tests/test_tiled_transform.py``; the JAX kernels run in interpret mode.
Tolerances:

* K3 (``normalize_with_matrix``), the tiled route: at most 1 uint8 step
  from JAX, on under 0.1% of the bytes (the OD table and ``exp`` round in
  another library); the route against the port's functional ``transform``
  within JAX's own budgets (``test_tiled_transform.py``: <=1 u8 with the
  functional estimate, <=3 and share >1 below 1e-2 with the fused fit).
* K4 (``macenko_fit_planar``): stain rows atol 5e-5 and maxC rtol 1e-4;
  K10 (``eigenplane``): atol 5e-5. The port sums the moments in float64,
  the JAX kernels in float32.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stainlib_tpu.kernels import fused_stain as jax_fs  # noqa: E402
from stainlib_tpu.kernels import macenko_fused as jax_k  # noqa: E402
from stainlib_tpu.normalization import extractive as jax_ex  # noqa: E402
from stainlib_tpu_torch import api as tapi  # noqa: E402
from stainlib_tpu_torch.convert import params_from_jax  # noqa: E402
from stainlib_tpu_torch.kernels import fused_stain as fs  # noqa: E402
from stainlib_tpu_torch.kernels import macenko_fused as mf  # noqa: E402
from stainlib_tpu_torch.normalization import extractive  # noqa: E402
from tests.synth import he_batch, he_patch  # noqa: E402


def _diff(got, want):
    return np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))


def _u8_close(got, want):
    d = _diff(got, want)
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def _planar(img):
    return np.array(jax_fs.to_planar(jnp.asarray(img)))


def _params(method, seed):
    jp = jax_ex.fit(jnp.asarray(he_patch(32, 64, seed=seed)), method=method)
    return jp, params_from_jax(np.asarray(jp.stain_matrix_target),
                               np.asarray(jp.max_c_target), "cpu")


def test_blockify_roundtrip_matches_jax():
    x = np.random.default_rng(5).integers(0, 255, size=(2, 70, 90, 3),
                                          dtype=np.uint8)
    blocks, grid = fs.blockify(torch.from_numpy(x), 32)
    jblocks, jgrid = jax_fs.blockify(jnp.asarray(x), 32)
    assert grid == jgrid == (3, 3) and blocks.shape == (18, 32, 32, 3)
    assert (blocks.numpy() == np.asarray(jblocks)).all()
    assert (fs.unblockify(blocks, grid, 70, 90).numpy() == x).all()


def test_tiled_est_stride_matches_jax():
    """``tests/test_tiled_transform.py:79-88``'s table."""
    for h, w, s in ((600, 600, 2), (1024, 1024, 4), (2048, 2048, 8),
                    (4096, 4096, 16), (512, 512, 2), (513, 700, 2)):
        assert extractive.tiled_est_stride(h, w) == s
        assert jax_ex.tiled_est_stride(h, w) == s
    assert extractive.tiled_est_stride(96, 96, floor=24 * 24) == 4


def test_plain_k3_matches_jax_kernel():
    img = he_batch(2, 96, 128, seed=50)
    jp, tp = _params("macenko", 40)
    M, mc = jax_ex.estimate_source(jnp.asarray(img))
    args = (np.asarray(M), np.asarray(mc), np.asarray(jp.stain_matrix_target),
            np.asarray(jp.max_c_target))
    want = jax_k.normalize_with_matrix_planar(jnp.asarray(_planar(img)),
                                              *args, interpret=True)
    got = mf.normalize_with_matrix_planar(torch.from_numpy(_planar(img)),
                                          *args)
    _u8_close(got, want)
    # The interleaved entry takes any field size and equals the planar one.
    whole = mf.normalize_with_matrix(torch.from_numpy(img), *args)
    assert torch.equal(fs.from_planar(got, 96, 128), whole)


def test_plain_k4_and_k10_match_jax_kernels():
    img = he_batch(2, 96, 128, seed=50)
    planar = _planar(img)
    jM, jmc = jax_k.macenko_fit_planar(jnp.asarray(planar), interpret=True)
    M, mc = mf.macenko_fit_planar(torch.from_numpy(planar))
    assert M.shape == (2, 2, 3) and mc.shape == (2, 2)
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), rtol=0, atol=5e-5)
    np.testing.assert_allclose(mc.numpy(), np.asarray(jmc), rtol=1e-4)
    V = mf.eigenplane(torch.from_numpy(planar))
    assert V.shape == (2, 3, 2)
    np.testing.assert_allclose(
        V.numpy(), np.asarray(jax_k.eigenplane(jnp.asarray(planar),
                                               interpret=True)),
        rtol=0, atol=5e-5)


@pytest.mark.parametrize("tiles", ["white_and_he", "one_512"])
def test_plain_k10_matches_jax_on_background_and_large_tiles(tiles):
    """A tile with no tissue (all white: zero moments, the clamped scale and
    the degenerate eigenvector branch) beside an H&E tile, and one 512^2
    tile."""
    if tiles == "white_and_he":
        img = he_batch(2, 128, 128, seed=51)
        img[0] = 255
    else:
        img = he_batch(1, 512, 512, seed=52)
    planar = _planar(img)
    V = mf.eigenplane(torch.from_numpy(planar))
    np.testing.assert_allclose(
        V.numpy(), np.asarray(jax_k.eigenplane(jnp.asarray(planar),
                                               interpret=True)),
        rtol=0, atol=5e-5)
    if tiles == "white_and_he":
        assert V[0].tolist() == [[1.0, 1.0], [0.0, 0.0], [0.0, 0.0]]


@pytest.mark.parametrize("shared", [True, False])
def test_plain_k3_matches_jax_with_shared_and_per_tile_rows(shared):
    """The slide-level case (one (2, 3) source matrix and (2,) maxC for
    every tile) and per-tile rows (the tiled route's K4 output)."""
    img = he_batch(3, 64, 128, seed=53)
    planar = _planar(img)
    jp, _ = _params("macenko", 41)
    M, mc = mf.macenko_fit_planar(torch.from_numpy(planar))
    src = (M[1].numpy(), mc[1].numpy()) if shared else (M.numpy(),
                                                        mc.numpy())
    args = (*src, np.asarray(jp.stain_matrix_target),
            np.asarray(jp.max_c_target))
    want = jax_k.normalize_with_matrix_planar(jnp.asarray(planar), *args,
                                              interpret=True)
    got = mf.normalize_with_matrix_planar(torch.from_numpy(planar), *args)
    _u8_close(got, want)
    if shared:
        per_tile = mf.normalize_with_matrix_planar(
            torch.from_numpy(planar), np.broadcast_to(args[0], (3, 2, 3)),
            np.broadcast_to(args[1], (3, 2)), *args[2:])
        assert torch.equal(per_tile, got)


def test_k3_pointer_arguments_take_shared_or_per_image_values():
    """K3's per-image values as (tensor, stride): a float32 contiguous
    tensor on the device passes as it is, stride 0 when shared and the
    width when per image; anything else is converted once; a wrong width
    raises."""
    M = torch.rand(4, 2, 3)
    mc = torch.rand(4, 2)
    ptrs = mf._matrix_args(M, mc, M[0], mc[0].numpy(), 4, torch.device("cpu"))
    assert [stride for _, stride in ptrs] == [6, 2, 0, 0]
    assert ptrs[0][0] is M and ptrs[1][0] is mc
    assert ptrs[3][0].dtype == torch.float32
    for bad in (torch.rand(4, 3), torch.rand(2, 2, 3), torch.rand(5)):
        with pytest.raises(ValueError, match="expected"):
            mf._matrix_args(M, mc, bad, mc, 4, torch.device("cpu"))
    with pytest.raises(ValueError, match="expected"):
        mf._matrix_args(M, torch.rand(4, 3), M, mc, 4, torch.device("cpu"))


@pytest.mark.parametrize("method,shape,kw,budget", [
    # Ragged, lane-unaligned field: the white-padding path, functional fit.
    ("macenko", (72, 88), dict(block=32), 1),
    # 96^2 = 9216-pixel subsample: the fit kernel K4 engages.
    ("macenko", (192, 192), dict(block=64, est_stride=2), 3),
    ("vahadane", (64, 96), dict(block=32), 1),
])
def test_transform_tiled_matches_jax_and_functional(method, shape, kw,
                                                     budget):
    jp, tp = _params(method, 44)
    img = he_batch(1, *shape, seed=45)[0]
    want = jax_ex.transform_tiled(jp, jnp.asarray(img), method=method,
                                  interpret=True, **kw)
    got = extractive.transform_tiled(tp, torch.from_numpy(img),
                                     method=method, **kw)
    assert got.dtype == torch.uint8 and got.shape == img.shape
    _u8_close(got, want)
    # K3 on the whole field in one launch gives the blockified bytes.
    whole = extractive.transform_tiled(tp, torch.from_numpy(img),
                                       method=method,
                                       **{**kw, "block": None})
    assert torch.equal(whole, got)
    d = _diff(got, extractive.transform(tp, torch.from_numpy(img),
                                        method=method))
    assert d.max() <= budget and (d > 1).mean() < 1e-2, (d.max(),
                                                        (d > 1).mean())


def test_transform_tiled_batch_and_fused_fit_gate(monkeypatch):
    """Each image gets its own estimate; the fit kernel engages only at
    8192..512^2 subsample pixels and never with extractor knobs."""
    _, tp = _params("macenko", 42)
    batch = torch.from_numpy(he_batch(2, 64, 64, seed=43))
    got = extractive.transform_tiled(tp, batch)
    for i in range(2):
        assert torch.equal(extractive.transform_tiled(tp, batch[i]), got[i])
    calls = []
    real = extractive.macenko_fit_planar
    monkeypatch.setattr(extractive, "macenko_fit_planar",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a,
                                                                       **k))
    img = torch.from_numpy(he_batch(1, 192, 192, seed=49)[0])
    extractive.transform_tiled(tp, img, est_stride=2)
    assert calls == [(1, 3, 9216 // 128, 128)]
    extractive.transform_tiled(tp, img, est_stride=2, fused_fit=False)
    extractive.transform_tiled(tp, img, est_stride=2,
                               luminosity_threshold=0.8)
    extractive.transform_tiled(tp, img[:64, :64], est_stride=2)  # 1024 px
    assert len(calls) == 1


def test_api_routes_large_fields_to_the_tiled_route(monkeypatch):
    """On a CUDA device, images over 512^2 take the tiled route with the
    API's grid stride (``api.py:82-89,191-197``); the CPU keeps the
    functional path."""
    big = np.zeros((1024, 1024, 3), np.uint8)
    assert tapi._use_tiled(big, "cuda")
    assert tapi._use_tiled(np.zeros((513, 512, 3), np.uint8), "cuda")
    assert not tapi._use_tiled(np.zeros((512, 512, 3), np.uint8), "cuda")
    assert not tapi._use_tiled(big, "cpu")
    assert not tapi._use_fused(big, "cuda")
    # The drop-in transform runs the tiled route where _use_tiled says so
    # (here forced on the CPU, where the kernels' plain versions run).
    img = he_batch(1, 600, 600, seed=60)[0]
    norm = tapi.ExtractiveStainNormalizer("macenko", device="cpu")
    norm.fit(he_patch(64, 64, seed=61))
    functional = norm.transform(img)
    monkeypatch.setattr(tapi, "_use_tiled", lambda I, device: True)
    before = (mf.fit_launches, mf.matrix_launches)
    tiled = norm.transform(img)
    assert (mf.fit_launches, mf.matrix_launches) == before  # CPU: no launch
    want = extractive.transform_tiled(norm._params, torch.from_numpy(img),
                                      est_stride=2).numpy()
    assert (tiled == want).all()
    d = _diff(tiled, functional)
    assert d.max() <= 3 and (d > 1).mean() < 1e-2, (d.max(), (d > 1).mean())


def test_wrappers_on_cpu_tensors():
    """A CPU tensor takes the plain version (no launch); shared and
    per-tile matrices agree; malformed input raises."""
    img = torch.from_numpy(he_batch(2, 32, 64, seed=96))
    planar = fs.to_planar(img).contiguous()
    M, mc = mf.macenko_fit_planar(planar)
    _, tp = _params("macenko", 90)
    tgt = (tp.stain_matrix_target, tp.max_c_target)
    before = (mf.matrix_launches, mf.fit_launches, mf.eigenplane_launches)
    out = mf.normalize_with_matrix(img, M, mc, *tgt)
    one = mf.normalize_with_matrix(img[:1], M[0], mc[0], *tgt)
    assert torch.equal(one[0], out[0])
    mf.eigenplane(planar)
    assert (mf.matrix_launches, mf.fit_launches,
            mf.eigenplane_launches) == before
    with pytest.raises(TypeError):
        mf.normalize_with_matrix(img.float(), M, mc, *tgt)
    with pytest.raises(ValueError):
        mf.normalize_with_matrix_planar(img, M, mc, *tgt)
    with pytest.raises(ValueError):
        mf.macenko_fit_planar(img)
    with pytest.raises(ValueError):
        mf.eigenplane(img)
    # Any field size: 33 x 33 is not a multiple of 128 pixels.
    odd = torch.from_numpy(he_batch(1, 33, 33, seed=97))
    assert mf.normalize_with_matrix(odd, M[0], mc[0], *tgt).shape == odd.shape
