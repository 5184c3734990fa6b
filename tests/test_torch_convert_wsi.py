"""The port's converter CLI (``scripts/torch_convert_wsi.py``) against the
JAX package's (``scripts/convert_wsi.py``), on the CPU: the cases of
``tests/test_convert_wsi.py`` on the port's script, each compared with
JAX's script on the same input.

* ``read_levels``: the same levels, byte for byte, from a ``.wsiraw``, a
  lossless ``.tif`` and (a stub ``openslide`` module) an OpenSlide-only
  container; synthesized levels equal the port's ``build_pyramid``'s.
* ``_to_uint8``: equal on uint16, float [0, 1] and float [0, 255] pages.
* ``main``: the written WSIRAW file byte-equal to JAX's.
* No decoder: the documented error, and nothing written.
"""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest

pytest.importorskip("jax")

from stainlib_tpu_torch.data import native  # noqa: E402
from stainlib_tpu_torch.data.preprocessing import build_pyramid  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_conv_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


port = _load("torch_convert_wsi")
jax_conv = _load("convert_wsi")

requires_tiff = pytest.mark.skipif(
    not native.tiff_native_available(), reason="libtiff toolchain missing")


def _level0(h=300, w=420, seed=5):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 4 + 1, w // 4 + 1, 3), np.uint8)
    lv = np.kron(base, np.ones((4, 4, 1), np.uint8))[:h, :w]
    return np.ascontiguousarray(lv ^ rng.integers(0, 8, lv.shape, np.uint8))


def _assert_same_levels(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("min_dim", [32, 64, 200])
def test_read_levels_wsiraw_equals_jax(tmp_path, min_dim):
    src = str(tmp_path / "in.wsiraw")
    lv0 = _level0()
    native.write_wsiraw(src, [lv0, lv0[::3, ::3].copy()])
    got = port.read_levels(src, min_dim)
    _assert_same_levels(got, jax_conv.read_levels(src, min_dim))
    assert np.array_equal(got[0], lv0)
    for i in range(2, len(got)):  # synthesized: 2x box means
        assert np.array_equal(got[i], build_pyramid(got[i - 1], 2)[1])
    assert min(got[-1].shape[:2]) < 2 * min_dim


@requires_tiff
def test_read_levels_tif_equals_jax(tmp_path):
    src = str(tmp_path / "in.tif")
    lv0 = _level0(256, 384, seed=6)
    native.write_tiff_pyramid(src, [lv0, lv0[::2, ::2].copy()], tile=64,
                              compression="deflate")
    got = port.read_levels(src, 32)
    _assert_same_levels(got, jax_conv.read_levels(src, 32))
    assert np.array_equal(got[0], lv0) and len(got) == 4


@pytest.mark.parametrize("page", [
    np.array([[0, 65535], [32768, 255]], np.uint16),
    np.array([[0.0, 0.5], [1.0, 1.2]], np.float32),
    np.array([[0.0, 100.0], [200.0, 255.0]], np.float32),
    np.linspace(0.0, 1.0, 64, dtype=np.float64).reshape(8, 8),
    np.arange(64, dtype=np.uint8).reshape(8, 8),
], ids=["uint16", "float01", "float255", "float64", "uint8"])
def test_to_uint8_equals_jax(page):
    arr = np.repeat(page[..., None], 3, -1)
    got = port._to_uint8(arr)
    want = jax_conv._to_uint8(arr)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_to_uint8_rejects_what_jax_rejects():
    arr = np.zeros((2, 2, 3), np.int16)
    with pytest.raises(ValueError, match="unsupported page dtype"):
        jax_conv._to_uint8(arr)
    with pytest.raises(ValueError, match="unsupported page dtype"):
        port._to_uint8(arr)


@pytest.mark.parametrize("min_dim", [16, 64])
def test_written_wsiraw_equals_jax(tmp_path, capsys, min_dim):
    src = str(tmp_path / "in.wsiraw")
    native.write_wsiraw(src, [_level0(seed=7)])
    a, b = str(tmp_path / "jax.wsiraw"), str(tmp_path / "port.wsiraw")
    assert jax_conv.main([src, a, "--min-dim", str(min_dim)]) == 0
    jax_out = capsys.readouterr().out
    assert port.main([src, b, "--min-dim", str(min_dim)]) == 0
    port_out = capsys.readouterr().out
    assert open(a, "rb").read() == open(b, "rb").read()
    assert port_out.replace("port.wsiraw", "jax.wsiraw") == jax_out
    s = native.open_slide(b)
    assert s.num_levels == len(port.read_levels(src, min_dim))
    s.close()


class _FakeRegion:
    def __init__(self, arr):
        self._arr = arr

    def convert(self, mode):
        assert mode == "RGB"
        from PIL import Image

        return Image.fromarray(self._arr)


class _FakeOpenSlide:
    """Minimal OpenSlide.read_region surface (data_utils.py:1)."""

    opened = []

    def __init__(self, path):
        self.closed = False
        rng = np.random.default_rng(11)
        self._levels = [rng.integers(0, 255, (128, 160, 3), np.uint8),
                        rng.integers(0, 255, (64, 80, 3), np.uint8)]
        _FakeOpenSlide.opened.append(self)

    @property
    def level_dimensions(self):
        return [(a.shape[1], a.shape[0]) for a in self._levels]

    def read_region(self, origin, level, size):
        assert origin == (0, 0) and size == self.level_dimensions[level]
        return _FakeRegion(self._levels[level])

    def close(self):
        self.closed = True


@pytest.fixture
def fake_openslide(monkeypatch):
    pytest.importorskip("PIL")
    mod = types.ModuleType("openslide")
    mod.OpenSlide = _FakeOpenSlide
    monkeypatch.setitem(sys.modules, "openslide", mod)
    _FakeOpenSlide.opened.clear()
    return mod


def test_openslide_branch_equals_jax(fake_openslide, tmp_path):
    src = tmp_path / "slide.mrxs"
    src.write_bytes(b"not a real mirax file")
    got = port.read_levels(str(src), min_dim=32)
    assert got[0].shape == (128, 160, 3) and got[1].shape == (64, 80, 3)
    assert _FakeOpenSlide.opened and _FakeOpenSlide.opened[0].closed
    _assert_same_levels(got, jax_conv.read_levels(str(src), min_dim=32))
    dst = tmp_path / "out.wsiraw"
    assert port.main([str(src), str(dst), "--min-dim", "32"]) == 0
    s = native.open_slide(str(dst))
    try:
        assert s.level_size(0) == (160, 128)
        assert np.array_equal(s.read_region(0, 0, 0, 32, 32),
                              _FakeOpenSlide.opened[0]._levels[0][:32, :32])
    finally:
        s.close()


def test_no_decoder_error_and_nothing_written(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "openslide", None)
    src = tmp_path / "slide.mrxs"
    src.write_bytes(b"\x01\x02\x03 definitely not an image")
    with pytest.raises(ValueError) as want:
        jax_conv.read_levels(str(src), min_dim=32)
    with pytest.raises(ValueError, match=r"\.mrxs.*openslide-python") as got:
        port.read_levels(str(src), min_dim=32)
    assert str(got.value) == str(want.value)
    # No decoder at all (the card's host: no OpenSlide, tifffile or PIL):
    # the same error, and no output file.
    monkeypatch.setitem(sys.modules, "tifffile", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    dst = tmp_path / "out.wsiraw"
    with pytest.raises(ValueError, match="no available decoder"):
        port.main([str(src), str(dst)])
    assert not dst.exists()
