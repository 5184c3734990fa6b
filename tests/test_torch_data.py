"""The port's data layer (``stainlib_tpu_torch.data``) against the JAX
package's, on the CPU.

The counterparts of ``tests/test_native_data.py``,
``tests/test_tiff_ingestion.py`` and the prefetcher tests of
``tests/test_wsi_pipeline.py:92-150``. Both packages read the same files,
written by either; every reader, the sampler (same seed), the HSV tissue
mask and the planar repack must give the JAX package's bytes exactly. The
prefetcher runs on the CPU device here (its CUDA ring is held in
``tests/test_torch_slide_cuda.py``).
"""

import subprocess
import threading
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from stainlib_tpu.data import manifests as jax_manifests  # noqa: E402
from stainlib_tpu.data import native as jn  # noqa: E402
from stainlib_tpu.data import preprocessing as jax_pre  # noqa: E402
from stainlib_tpu_torch.data import manifests, native, preprocessing  # noqa: E402
from stainlib_tpu_torch.data.pipeline import DevicePrefetcher  # noqa: E402
from tests.synth import he_patch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

requires_tiff = pytest.mark.skipif(
    not jn.tiff_native_available(), reason="libtiff toolchain missing")


@pytest.fixture(scope="module")
def levels():
    """A two-level pyramid: tissue in the center, a white border."""
    lv0 = np.full((256, 320, 3), 255, np.uint8)
    lv0[64:192, 80:240] = he_patch(128, 160, seed=1, background_frac=0.0)
    return [lv0, lv0[::2, ::2].copy()]


@pytest.fixture(scope="module")
def raw_path(tmp_path_factory, levels):
    path = str(tmp_path_factory.mktemp("wsi") / "slide.wsr")
    native.write_wsiraw(path, levels)
    return path


@pytest.fixture(scope="module")
def tiff_path(tmp_path_factory, levels):
    if not native.tiff_native_available():
        pytest.skip("libtiff toolchain missing")
    path = str(tmp_path_factory.mktemp("tif") / "slide.tif")
    native.write_tiff_pyramid(path, levels, tile=64, compression="deflate")
    return path


def _pair(kind, raw_path, tiff_path):
    """(port handle, JAX handle) over the same file."""
    if kind == "raw":
        return native.RawSlide(raw_path), jn.RawSlide(raw_path)
    return native.TiffSlide(tiff_path), jn.TiffSlide(tiff_path)


def test_libraries_build_into_the_ignored_build_dir():
    """The port builds its own libraries under ``_native/_build`` (listed
    in ``.gitignore``), named by the hash of source and flags, and never
    loads the JAX package's."""
    assert native.build_native() is not None and native.native_available()
    for stem, lib in (("tilereader", native.get_lib()),
                      ("tiffreader", native.get_tiff_lib())):
        if lib is None:
            continue
        path = Path(lib._name)
        assert path.parent == native.BUILD_DIR, path
        assert path.name.startswith(f"lib{stem}_") and path.suffix == ".so"
        assert "stainlib_tpu/" not in str(path.relative_to(ROOT))
    ignored = subprocess.run(
        ["git", "check-ignore", "-q", str(native.BUILD_DIR / "x.so")],
        cwd=ROOT, capture_output=True)
    assert ignored.returncode in (0, 128)  # 128: not a git checkout
    rel = native.BUILD_DIR.relative_to(ROOT).as_posix()
    assert f"{rel}/" in (ROOT / ".gitignore").read_text().split()


def test_wsiraw_writer_matches_jax_bytes(tmp_path, levels):
    a, b = str(tmp_path / "a.wsr"), str(tmp_path / "b.wsr")
    native.write_wsiraw(a, levels)
    jn.write_wsiraw(b, levels)
    assert Path(a).read_bytes() == Path(b).read_bytes()


@pytest.mark.parametrize("kind", ["raw", pytest.param("tiff",
                                                      marks=requires_tiff)])
def test_geometry_and_regions_match_jax(kind, raw_path, tiff_path, levels):
    s, j = _pair(kind, raw_path, tiff_path)
    try:
        assert s.native and s.num_levels == j.num_levels == 2
        for lv in range(2):
            assert s.level_size(lv) == j.level_size(lv)
        for args in ((0, 100, 70, 64, 48), (0, -8, -8, 16, 16),
                     (1, 150, 120, 40, 40), (0, 10_000, 10_000, 8, 8)):
            got = s.read_region(*args)
            assert np.array_equal(got, j.read_region(*args)), args
        assert np.array_equal(s.read_region(0, 100, 70, 64, 48),
                              levels[0][70:118, 100:164])
    finally:
        s.close()
        j.close()


@requires_tiff
def test_read_regions_matches_jax(raw_path, tiff_path):
    s, j = _pair("tiff", raw_path, tiff_path)
    coords = np.array([[0, 0], [64, 64], [300, 200], [-10, 5], [128, 192]])
    try:
        got = s.read_regions(0, coords, 64, 64)
        assert got.shape == (5, 64, 64, 3)
        assert np.array_equal(got, j.read_regions(0, coords, 64, 64))
        for i, (x, y) in enumerate(coords):
            assert np.array_equal(got[i], s.read_region(0, x, y, 64, 64))
    finally:
        s.close()
        j.close()


@pytest.mark.parametrize("kind", ["raw", pytest.param("tiff",
                                                      marks=requires_tiff)])
def test_sample_tiles_matches_jax(kind, raw_path, tiff_path):
    s, j = _pair(kind, raw_path, tiff_path)
    mask = np.zeros((256, 320), np.uint8)
    mask[64:160, 80:160] = 1
    try:
        for kw in (dict(seed=7), dict(seed=3, mask=mask, mask_scale=1.0)):
            tiles, coords = s.sample_tiles(0, 32, 16, **kw)
            jt, jc = j.sample_tiles(0, 32, 16, **kw)
            assert np.array_equal(coords, jc) and np.array_equal(tiles, jt)
            ok = coords[:, 0] >= 0
            assert ok.sum() >= 8
            flat = tiles[ok].reshape(ok.sum(), -1)
            assert (flat.mean(1) <= 230.0).all() and (flat.std(1) >= 15).all()
        # A level smaller than the tile: gray filler and (-1, -1).
        tiles, coords = s.sample_tiles(1, 512, 3, seed=1)
        assert (coords == -1).all() and (tiles == 128).all()
    finally:
        s.close()
        j.close()


def test_tissue_mask_hsv_and_pack_planar_match_jax(levels):
    kw = dict(h_range=(0, 180), s_range=(20, 255), v_range=(30, 255),
              k_close=9, k_open=7)
    got = native.tissue_mask_hsv(levels[0], **kw)
    assert np.array_equal(got, jn.tissue_mask_hsv(levels[0], **kw))
    assert got[80:180, 96:224].mean() > 0.8 and got[:50].mean() < 0.05
    batch = np.stack([he_patch(32, 32, seed=s) for s in range(3)])
    planar = native.pack_planar(batch)
    assert np.array_equal(planar, jn.pack_planar(batch))
    assert np.array_equal(planar, batch.transpose(0, 3, 1, 2).reshape(
        3, 3, 8, 128))
    with pytest.raises(ValueError):
        native.pack_planar(np.zeros((1, 5, 5, 3), np.uint8))


def test_wsiraw_round_trip_and_open_slide(tmp_path, levels):
    path = str(tmp_path / "rt.wsiraw")
    preprocessing.array_to_wsiraw(path, levels[0], n_levels=3)
    s = native.open_slide(path)
    try:
        assert isinstance(s, native.RawSlide) and s.num_levels == 3
        want = jax_pre.build_pyramid(levels[0], 3)
        for lv, arr in enumerate(want):
            w, h = s.level_size(lv)
            assert (h, w) == arr.shape[:2]
            assert np.array_equal(s.read_region(lv, 0, 0, w, h), arr)
    finally:
        s.close()


@requires_tiff
@pytest.mark.parametrize("comp", ["none", "deflate", "lzw", "jpeg"])
def test_tiff_round_trip_both_ways(tmp_path, levels, comp):
    """The port's writer read by JAX's reader, and JAX's writer read by the
    port's: the same bytes either way (JPEG: a mean error under 3)."""
    a, b = str(tmp_path / "port.tif"), str(tmp_path / "jax.tif")
    native.write_tiff_pyramid(a, levels, tile=64, compression=comp)
    jn.write_tiff_pyramid(b, levels, tile=64, compression=comp)
    for writer, reader in ((a, jn.TiffSlide), (b, native.TiffSlide),
                           (a, native.TiffSlide)):
        s = reader(writer)
        try:
            assert s.native and s.num_levels == 2
            got = s.read_region(0, 0, 0, 320, 256)
        finally:
            s.close()
        if comp == "jpeg":
            assert np.abs(got.astype(float) - levels[0]).mean() < 3.0
        else:
            assert np.array_equal(got, levels[0])
    assert isinstance(native.open_slide(a), native.TiffSlide)
    with pytest.raises(ValueError, match="multiples of 16"):
        native.write_tiff_pyramid(str(tmp_path / "x.tif"), levels, tile=24)


def test_level_out_of_range_raises(raw_path):
    s = native.RawSlide(raw_path)
    try:
        with pytest.raises(IndexError):
            s.level_size(5)
        with pytest.raises(IndexError):
            s.read_region(5, 0, 0, 16, 16)
        with pytest.raises(IndexError):
            s.sample_tiles(-1, 16, 2)
    finally:
        s.close()


def test_numpy_fallback_matches_native(raw_path, levels, monkeypatch):
    n = native.RawSlide(raw_path)
    want = n.read_region(0, -5, 100, 64, 48)
    n.close()
    batch = np.stack([he_patch(16, 16, seed=9)] * 2)
    planar = native.pack_planar(batch)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    s = native.RawSlide(raw_path)
    assert not s.native and s.num_levels == 2
    assert s.level_size(1) == (160, 128)
    assert np.array_equal(s.read_region(0, -5, 100, 64, 48), want)
    tiles, coords = s.sample_tiles(0, tile=32, n=4, seed=5)
    assert (coords[:, 0] >= 0).any()
    assert np.array_equal(native.pack_planar(batch), planar)
    with pytest.raises(IndexError):
        s.read_region(2, 0, 0, 8, 8)


@requires_tiff
def test_pil_fallback_reader(tiff_path, levels, monkeypatch):
    assert all(np.array_equal(a, b) for a, b in zip(
        native._read_tiff_pil(tiff_path), levels))
    monkeypatch.setattr(native, "get_tiff_lib", lambda: None)
    s = native.TiffSlide(tiff_path)
    assert not s.native and s.num_levels == 2
    got = s.read_regions(0, [[0, 0], [300, 240]], 32, 32)
    assert np.array_equal(got[0], levels[0][:32, :32])
    assert (got[1][16:] == 255).all()
    with pytest.raises(RuntimeError, match="TIFF writer unavailable"):
        native.write_tiff_pyramid(str(tiff_path) + ".x", levels)


def test_corrupt_wsiraw_header_rejected(tmp_path):
    path = str(tmp_path / "evil.wsr")
    with open(path, "wb") as f:
        f.write(np.uint32(native.MAGIC).tobytes())
        f.write(np.uint32(1).tobytes())
        f.write(np.uint32(0x80000000).tobytes())  # w
        f.write(np.uint32(0x80000000).tobytes())  # h: 3*w*h wraps mod 2^64
        f.write(np.zeros(2, np.uint32).tobytes())
        f.write(b"\x00" * 64)
    with pytest.raises(ValueError):
        native.RawSlide(path)


def test_preprocessing_and_manifests_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    lv0 = rng.integers(0, 256, (67, 90, 3), np.uint8)
    for a, b in zip(preprocessing.build_pyramid(lv0, 4),
                    jax_pre.build_pyramid(lv0, 4)):
        assert np.array_equal(a, b)
    paths = preprocessing.images_to_npy_shards(lv0[None].repeat(5, 0),
                                               str(tmp_path), shard_size=2)
    assert len(paths) == 3
    assert np.array_equal(preprocessing.load_npy_shards(paths),
                          lv0[None].repeat(5, 0))
    names = [f"s{i}.svs" for i in range(17)]
    fr = dict(train=0.6, val=0.2)
    split = manifests.split_manifest(names, fr, seed=4)
    assert split == jax_manifests.split_manifest(names, fr, seed=4)
    files = manifests.write_split_manifests(str(tmp_path), split, "x_")
    assert manifests.read_manifest(files["val"]) == split["val"]
    with pytest.raises(ValueError):
        manifests.split_manifest(names, dict(a=0.7, b=0.5))


# ---------------------------------------------------------------------------
# DevicePrefetcher on the CPU device (tests/test_wsi_pipeline.py:92-150)
# ---------------------------------------------------------------------------


def test_prefetcher_orders_and_finishes():
    batches = [np.full((2, 4, 4, 3), i, np.uint8) for i in range(5)]
    out = list(DevicePrefetcher(iter(batches), depth=2, device="cpu"))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert isinstance(b, torch.Tensor) and b.dtype == torch.uint8
        assert b.shape == (2, 4, 4, 3) and int(b[0, 0, 0, 0]) == i


def test_prefetcher_propagates_errors():
    def gen():
        yield np.zeros((1, 2, 2, 3), np.uint8)
        raise ValueError("boom")

    it = DevicePrefetcher(gen(), depth=1, device="cpu")
    next(it)
    with pytest.raises(ValueError):
        for _ in it:
            pass


def test_prefetcher_multiworker_order_and_structure():
    """Order kept across workers; nested batches keep their structure and
    the transform runs on the host threads."""
    batches = [(np.full((4,), i, np.int32), {"y": np.float32(i)})
               for i in range(24)]
    seen = set()

    def transform(b):
        seen.add(threading.current_thread().name)
        return b

    feed = DevicePrefetcher(iter(batches), depth=4, workers=3,
                            transform=transform, device="cpu")
    got = list(feed)
    assert [int(x[0]) for x, _ in got] == list(range(24))
    assert all(isinstance(d["y"], torch.Tensor) and float(d["y"]) == i
               for i, (_, d) in enumerate(got))
    assert threading.main_thread().name not in seen


def test_prefetcher_multiworker_error_keeps_prefix():
    """Batches sequenced before the first failure are still delivered (the
    prefix of a single-worker run), then the error is raised."""

    def transform(b):
        if int(b[0]) == 7:
            raise ValueError("boom at 7")
        return b

    batches = [np.full((4,), i, np.int32) for i in range(10)]
    feed = DevicePrefetcher(iter(batches), depth=4, workers=3,
                            transform=transform, device="cpu")
    got = []
    with pytest.raises(ValueError, match="boom at 7"):
        for b in feed:
            got.append(int(b[0]))
    assert got == list(range(7)), got


def test_prefetcher_defaults_to_cuda():
    """The default device is CUDA; without a card it raises rather than
    falling back to the CPU."""
    import inspect

    sig = inspect.signature(DevicePrefetcher.__init__)
    assert sig.parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DevicePrefetcher(iter([np.zeros(2)]))
