"""The port's whole-slide deployment (``normalization/slide.py``) against
the JAX package's, on the CPU.

Both sides read the same synthetic slides (``tests/synth.py`` tiles of
128^2 with a white band and partial edge tiles) and write lossless TIFFs,
which are read back and compared. Tolerances:

* ``fit_slide``: stain rows atol 1e-4 and maxC rtol 1e-4 against JAX
  (``tests/test_torch_macenko.py:108-118``; measured 5.2e-5 and 1.3e-6 for
  Macenko, 3.3e-5 and 4.7e-5 for Vahadane on the 131k-pixel mosaic: the
  JAX package sums its moments and contractions in float32), and the
  Macenko rows atol 1e-5 against a float64 evaluation (measured 7e-8);
  ``fit_slide_reinhard``: LAB means and stds atol 2e-4, the same divisor.
* written bytes: each side from one estimate (the JAX fit, carried over by
  ``convert``), at most 1 uint8 step apart on under 0.1% of the bytes
  (``tests/test_torch_macenko.py:37``, ``tests/test_torch_reinhard.py:53``).
  The kernel route is held in ``tests/test_torch_slide_kernel.py``.
* ``build_pyramid`` and the memmap canvas: identical bytes.
* ``normalize_slide(mesh=...)`` on a 2-rank gloo world
  (``tests/_torch_mp_worker.py``): the single-device bytes.
"""

import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stainlib_tpu.normalization import extractive as jax_ex  # noqa: E402
from stainlib_tpu.normalization import reinhard as jax_rh  # noqa: E402
from stainlib_tpu.normalization import slide as jax_slide  # noqa: E402
from stainlib_tpu.ops.tissue import tissue_mask as jax_mask  # noqa: E402
from stainlib_tpu_torch import convert  # noqa: E402
from stainlib_tpu_torch.data import native  # noqa: E402
from stainlib_tpu_torch.normalization import slide  # noqa: E402
from tests._torch_mp_worker import run_world  # noqa: E402
from tests.synth import he_batch, he_patch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
W, H, TILE = 330, 370, 128
FIT = dict(tile=TILE, n_tiles=8, seed=3)

requires_tiff = pytest.mark.skipif(
    not native.tiff_native_available(), reason="libtiff toolchain missing")

TGT_STAIN = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]])
TGT_STAIN = TGT_STAIN / np.linalg.norm(TGT_STAIN, axis=1, keepdims=True)


def _level0(seed=0):
    tiles = he_batch(9, TILE, TILE, seed=seed, background_frac=0.0)
    lv0 = np.concatenate([np.concatenate(list(tiles[r * 3:r * 3 + 3]),
                                         axis=1) for r in range(3)],
                         axis=0)[:H, :W]
    lv0[:12] = 255  # a white margin band
    return lv0


@pytest.fixture(scope="module")
def slide_tif(tmp_path_factory):
    if not native.tiff_native_available():
        pytest.skip("libtiff toolchain missing")
    path = str(tmp_path_factory.mktemp("slide") / "tissue.tif")
    native.write_tiff_pyramid(path, [_level0()], tile=64,
                              compression="deflate")
    return path


@pytest.fixture(scope="module")
def slide_raw(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("slide") / "tissue.wsiraw")
    native.write_wsiraw(path, [_level0(seed=1)])
    return path


def _read0(path):
    s = native.TiffSlide(path)
    try:
        return s.read_region(0, 0, 0, *s.level_size(0))
    finally:
        s.close()


def _u8_close(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def _stain_matrix_f64(img, mask, q=99.0):
    """The Macenko estimate in float64 numpy over the masked pixels."""
    od = np.maximum(-np.log(np.maximum(img.astype(np.float64), 1.0) / 255.0),
                    1e-6).reshape(-1, 3)[mask.reshape(-1)]
    _, V = np.linalg.eigh(np.cov(od, rowvar=False))
    V = V[:, [2, 1]]
    V = V * np.where(V[0] < 0, -1.0, 1.0)
    proj = od @ V
    phi = np.arctan2(proj[:, 1], proj[:, 0])
    lo, hi = np.percentile(phi, 100 - q), np.percentile(phi, q)
    v1 = V @ [np.cos(lo), np.sin(lo)]
    v2 = V @ [np.cos(hi), np.sin(hi)]
    HE = np.array([v1, v2]) if v1[0] > v2[0] else np.array([v2, v1])
    return HE / np.linalg.norm(HE, axis=1, keepdims=True)


def _targets(method, seed=40):
    """(JAX target params, the port's, converted) from one JAX fit."""
    target = he_patch(TILE, TILE, seed=seed, stain=TGT_STAIN,
                      background_frac=0.0)
    if method == "reinhard":
        jp = jax_rh.fit(jnp.asarray(target))
        return jp, convert.reinhard_params_from_jax(
            np.asarray(jp.means), np.asarray(jp.stds), "cpu")
    jp = jax_ex.fit(jnp.asarray(target), method=method)
    return jp, convert.params_from_jax(np.asarray(jp.stain_matrix_target),
                                       np.asarray(jp.max_c_target), "cpu")


def _share_slide_estimate(monkeypatch, path, method):
    """Make the port's normalize_slide use the JAX package's slide fit."""
    if method == "reinhard":
        p = convert.slide_reinhard_params_from_jax(
            jax_slide.fit_slide_reinhard(path, **FIT), "cpu")
        monkeypatch.setattr(slide, "fit_slide_reinhard", lambda *a, **k: p)
    else:
        p = convert.slide_params_from_jax(
            jax_slide.fit_slide(path, method=method, **FIT), "cpu")
        monkeypatch.setattr(slide, "fit_slide", lambda *a, **k: p)


def _run_both(tmp_path, path, method, estimation, interpret=False,
              seed=40, **kw):
    jt, tt = _targets(method, seed)
    args = dict(method=method, estimation=estimation, tile=TILE, batch=4,
                n_fit_tiles=8, seed=3, compression="none")
    args.update(kw)
    a, b = str(tmp_path / "jax.tif"), str(tmp_path / "port.tif")
    want = jax_slide.normalize_slide(path, a, jt, interpret=interpret, **args)
    got = slide.normalize_slide(path, b, tt, device="cpu", **args)
    return got, want, _read0(b), _read0(a)


def test_fit_slide_macenko_matches_jax_and_float64(slide_tif):
    p = slide.fit_slide(slide_tif, device="cpu", **FIT)
    jp = jax_slide.fit_slide(slide_tif, **FIT)
    assert p.stain_matrix.shape == (2, 3) and p.max_c.shape == (2,)
    assert p.stain_matrix.dtype == torch.float32
    np.testing.assert_allclose(p.stain_matrix.numpy(), jp.stain_matrix,
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(p.max_c.numpy(), jp.max_c, rtol=1e-4)
    s = native.open_slide(slide_tif)
    mosaic = slide._sample_mosaic(s, 0, TILE, 8, 3)
    s.close()
    mask = np.asarray(jax_mask(jnp.asarray(mosaic)).mask)
    np.testing.assert_allclose(p.stain_matrix.numpy(),
                               _stain_matrix_f64(mosaic, mask), rtol=0,
                               atol=1e-5)
    assert p.stain_matrix[0, 0] > p.stain_matrix[1, 0]  # H first


def test_fit_slide_vahadane_and_reinhard_match_jax(slide_tif):
    p = slide.fit_slide(slide_tif, method="vahadane", device="cpu", **FIT)
    jp = jax_slide.fit_slide(slide_tif, method="vahadane", **FIT)
    np.testing.assert_allclose(p.stain_matrix.numpy(), jp.stain_matrix,
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(p.max_c.numpy(), jp.max_c, rtol=1e-4)
    r = slide.fit_slide_reinhard(slide_tif, device="cpu", **FIT)
    jr = jax_slide.fit_slide_reinhard(slide_tif, **FIT)
    assert r.brightness_divisor == jr.brightness_divisor
    for got, want in ((r.stats.means, jr.stats.means),
                      (r.stats.stds, jr.stats.stds)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-4)


@pytest.mark.parametrize("method,estimation", [
    ("macenko", "slide"), ("vahadane", "slide"), ("reinhard", "slide"),
    ("macenko", "tile")])
def test_normalize_slide_functional_matches_jax(tmp_path, monkeypatch,
                                                slide_tif, method,
                                                estimation):
    if estimation == "slide":
        _share_slide_estimate(monkeypatch, slide_tif, method)
    info, want_info, got, want = _run_both(tmp_path, slide_tif, method,
                                           estimation)
    assert info == want_info and info["fused"] is False
    assert info["tiles"] == 9 and got.shape == (H, W, 3)
    _u8_close(got, want)
    if method != "reinhard":  # OD ~ 0 -> concentrations ~ 0 -> white
        assert got[:8].min() >= 250
    assert np.abs(got[100:300, 50:300].astype(int)
                  - _level0()[100:300, 50:300]).mean() > 2.0


def test_normalize_slide_wsiraw_input_and_partial_batch(tmp_path,
                                                        monkeypatch,
                                                        slide_raw):
    """A WSIRAW slide (per-region decode) with a batch that does not divide
    the 9 tiles (the padded trailing batch) and three prefetch workers."""
    _share_slide_estimate(monkeypatch, slide_raw, "macenko")
    info, want_info, got, want = _run_both(
        tmp_path, slide_raw, "macenko", "slide", seed=44, batch=5,
        prefetch_workers=3)
    assert info == want_info and info["tiles"] == 9
    _u8_close(got, want)


def test_memmap_canvas_identical(tmp_path, monkeypatch, slide_tif):
    """The disk-backed canvas and pyramid (a tiny RAM threshold) give the
    bytes of the in-RAM run (``tests/test_slide_normalize.py:234-255``)."""
    _, target = _targets("macenko", seed=44)
    kw = dict(method="macenko", tile=TILE, batch=4, n_fit_tiles=8, seed=3,
              compression="none", min_pyramid=64, device="cpu")
    a, b = str(tmp_path / "ram.tif"), str(tmp_path / "mmap.tif")
    slide.normalize_slide(slide_tif, a, target, **kw)
    allocated = []
    real = slide._alloc_u8
    monkeypatch.setattr(slide, "_RAM_CANVAS_BYTES", 1 << 10)
    monkeypatch.setattr(slide, "_alloc_u8",
                        lambda shape: allocated.append(real(shape))
                        or allocated[-1])
    info = slide.normalize_slide(slide_tif, b, target, **kw)
    assert info["levels"] == 3
    assert all(isinstance(x, np.memmap) for x in allocated)
    for lv in range(3):
        sa, sb = native.TiffSlide(a), native.TiffSlide(b)
        w, h = sa.level_size(lv)
        assert sb.level_size(lv) == (w, h)
        assert np.array_equal(sa.read_region(lv, 0, 0, w, h),
                              sb.read_region(lv, 0, 0, w, h))
        sa.close(), sb.close()


def test_build_pyramid_matches_jax():
    rng = np.random.default_rng(5)
    for shape, min_dim in (((257, 515, 3), 64), ((1024, 1024, 3), 128)):
        lv0 = rng.integers(0, 256, shape, np.uint8)
        got = slide.build_pyramid(lv0, min_dim=min_dim)
        want = jax_slide.build_pyramid(lv0, min_dim=min_dim)
        assert len(got) == len(want) > 1
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert [lv.shape[0] for lv in got] == [1024, 512, 256, 128]


def test_route_gate_and_grid():
    """The kernels' route: a CUDA device and the JAX package's shape gate
    (``slide.py:155-157``); the CPU takes the functional route."""
    assert slide._use_fused(256, "cuda") and slide._use_fused(512, "cuda")
    assert slide._use_fused(64, torch.device("cuda", 0))
    assert not slide._use_fused(256, "cpu")
    assert not slide._use_fused(513, "cuda")  # over 512^2
    assert not slide._use_fused(100, "cuda")  # 10,000 px: not 128-aligned
    assert slide._grid_coords(W, H, TILE) == jax_slide._grid_coords(W, H,
                                                                    TILE)


def test_defaults_are_cuda_and_errors_raise(tmp_path, slide_raw):
    for fn in (slide.normalize_slide, slide.fit_slide,
               slide.fit_slide_reinhard):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            slide.fit_slide(slide_raw)
    _, target = _targets("macenko")
    with pytest.raises(ValueError, match="unknown method"):
        slide.normalize_slide(slide_raw, "x.tif", target, method="x",
                              device="cpu")
    with pytest.raises(ValueError, match="unknown estimation"):
        slide.normalize_slide(slide_raw, "x.tif", target, estimation="x",
                              device="cpu")


def test_writer_unavailable_raises(tmp_path, monkeypatch, slide_raw):
    """Without libtiff the TIFF writer raises, as the JAX package's does
    (``native.py:394-396``); the stream before it still ran."""
    _, target = _targets("macenko")
    monkeypatch.setattr(native, "get_tiff_lib", lambda: None)
    calls = []
    monkeypatch.setattr(slide, "write_tiff_pyramid",
                        lambda *a, **k: calls.append(a[1]) or
                        native.write_tiff_pyramid(*a, **k))
    with pytest.raises(RuntimeError, match="TIFF writer unavailable"):
        slide.normalize_slide(slide_raw, str(tmp_path / "o.tif"), target,
                              tile=TILE, batch=4, n_fit_tiles=4,
                              device="cpu")
    assert calls and calls[0][0].shape == (H, W, 3)


@requires_tiff
def test_cli_script_runs_on_the_cpu(tmp_path, slide_raw):
    """``scripts/torch_normalize_wsi.py`` prints the summary dict."""
    out = str(tmp_path / "cli.tif")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_normalize_wsi.py"),
         slide_raw, out, "--device", "cpu", "--tile", str(TILE), "--batch",
         "4", "--fit-tiles", "4", "--compression", "deflate"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "330x370 (9 tiles" in proc.stdout and "fused=False" in proc.stdout
    assert _read0(out).shape == (H, W, 3)



@requires_tiff
def test_normalize_slide_over_a_mesh_equals_single_device(tmp_path,
                                                          slide_raw):
    """On a 2-rank gloo world (``tests/_torch_mp_worker.py``), slide-mode
    Macenko and tile-mode Reinhard over ``mesh=make_mesh()``: each rank
    normalizes its rows of each batch of 4 (the trailing batch padded),
    every rank's canvas equals the single-device canvas byte for byte, and
    only the first rank writes, the single-device file's bytes. JAX's
    errors for an unknown axis and a batch the axis does not divide."""
    target = he_patch(TILE, TILE, seed=40, stain=TGT_STAIN,
                      background_frac=0.0)
    outs = run_world("slide", 2, tmp_path, dict(
        src=slide_raw, target=target, tile=np.array(TILE),
        workdir=str(tmp_path)))
    for name in ("macenko_slide", "reinhard_tile"):
        single = _read0(str(tmp_path / f"{name}_0.tif"))
        assert np.array_equal(_read0(str(tmp_path / f"{name}_mesh.tif")),
                              single)
        for r, o in enumerate(outs):
            assert o[f"{name}_canvas"].shape == (H, W, 3)
            assert np.array_equal(o[f"{name}_canvas"], single), (name, r)
            assert np.array_equal(o[f"{name}_single"], single), (name, r)
            assert bool(o[f"{name}_written"]) == (r == 0)
        assert np.abs(single[100:300, 50:300].astype(int)
                      - _level0(seed=1)[100:300, 50:300]).mean() > 2.0
    for o in outs:
        assert str(o["err_axis"]) == ("mesh_axis 'tiles' not in mesh axes "
                                      "('data',)")
        assert str(o["err_batch"]) == ("batch (3) must be a multiple of the "
                                       "mesh's 'data' axis size (2)")


@requires_tiff
def test_cli_script_mesh_of_one(tmp_path, slide_raw):
    """``--mesh 1`` (a world of this process alone, no launcher) writes
    the bytes of the run without a mesh."""
    outs = []
    for mesh in ("0", "1"):
        out = str(tmp_path / f"cli_{mesh}.tif")
        proc = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "torch_normalize_wsi.py"),
             slide_raw, out, "--device", "cpu", "--tile", str(TILE),
             "--batch", "4", "--fit-tiles", "4", "--compression", "none",
             "--mesh", mesh],
            capture_output=True, text=True, cwd=ROOT, timeout=300)
        assert proc.returncode == 0, proc.stderr
        outs.append(_read0(out))
    assert np.array_equal(outs[0], outs[1])
