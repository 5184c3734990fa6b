"""The port's WSI sampler (``stainlib_tpu_torch.data.wsi``) against the JAX
package's, on the CPU.

Every case of ``tests/test_wsi_pipeline.py`` (parse, rasterize, match,
tumor quota, worker sharding, eval coverage, tissue regions), each also held
to the JAX sampler on the same files and seed: both samplers run the same
C++ core, so train and eval batches must be the same bytes. The JAX
sampler's prefetcher cases are in ``tests/test_torch_data.py``. The
sampler's slide sharding under a process group runs on a 2-rank gloo
world (``tests/_torch_mp_worker.py``).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from stainlib_tpu.data import wsi as jax_wsi  # noqa: E402
from stainlib_tpu_torch.data import native  # noqa: E402
from stainlib_tpu_torch.data.wsi import (  # noqa: E402
    SamplerConfig,
    WsiSampler,
    match_annotations,
    parse_asap_xml,
    rasterize_polygons,
)
from tests._torch_mp_worker import run_world  # noqa: E402
from tests.synth import he_patch  # noqa: E402

XML = """<ASAP_Annotations><Annotations>
  <Annotation Name="tum" Type="Polygon">
    <Coordinates>
      <Coordinate Order="0" X="64" Y="64"/>
      <Coordinate Order="1" X="160" Y="64"/>
      <Coordinate Order="2" X="160" Y="160"/>
      <Coordinate Order="3" X="64" Y="160"/>
    </Coordinates>
  </Annotation>
  <Annotation Name="tri" Type="Polygon">
    <Coordinates>
      <Coordinate Order="0" X="180.5" Y="40"/>
      <Coordinate Order="1" X="220" Y="120.25"/>
      <Coordinate Order="2" X="150" Y="100"/>
    </Coordinates>
  </Annotation>
  <Annotation Name="line" Type="Polygon">
    <Coordinates>
      <Coordinate Order="0" X="1" Y="1"/>
      <Coordinate Order="1" X="2" Y="2"/>
    </Coordinates>
  </Annotation></Annotations></ASAP_Annotations>"""


@pytest.fixture(scope="module")
def slide_dir(tmp_path_factory):
    """Two WSIRAW slides of 256^2 (tissue in [32, 224), a white border)
    with a 1/4 level, an annotation each, and TIFF copies."""
    d = tmp_path_factory.mktemp("slides")
    for i in range(2):
        lv0 = np.full((256, 256, 3), 255, np.uint8)
        lv0[32:224, 32:224] = he_patch(192, 192, seed=i, background_frac=0.0)
        lv1 = lv0[::4, ::4].copy()
        native.write_wsiraw(str(d / f"slide_{i:02d}.wsr"), [lv0, lv1])
        (d / f"slide_{i:02d}.xml").write_text(XML)
        if native.tiff_native_available():
            native.write_tiff_pyramid(str(d / f"slide_{i:02d}.tif"),
                                      [lv0, lv1], tile=64,
                                      compression="deflate")
    return d


def _paths(slide_dir, ext):
    if ext == "tif" and not native.tiff_native_available():
        pytest.skip("libtiff toolchain missing")
    return str(slide_dir / f"*.{ext}"), str(slide_dir / "*.xml")


def test_xml_parse_and_rasterize(slide_dir):
    path = str(slide_dir / "slide_00.xml")
    polys = parse_asap_xml(path)
    want = jax_wsi.parse_asap_xml(path)
    assert len(polys) == len(want) == 2 and polys[0].shape == (4, 2)
    assert all(p.dtype == np.float64 and np.array_equal(p, w)
               for p, w in zip(polys, want))
    mask = rasterize_polygons(polys[:1], 64, 64, scale=0.25)
    # The square (64..160 at level 0) maps to (16..40) at scale 1/4.
    assert mask[20, 20] and mask[35, 35]
    assert not mask[5, 5] and not mask[60, 60]
    assert 0.1 < mask.mean() < 0.25  # 24x24 of 64x64
    for shape, scale in (((64, 64), 0.25), ((256, 256), 1.0),
                         ((50, 70), 0.3)):
        got = rasterize_polygons(polys, *shape, scale=scale)
        assert got.dtype == bool
        assert np.array_equal(got, jax_wsi.rasterize_polygons(
            want, *shape, scale=scale)), (shape, scale)


def test_match_annotations(slide_dir):
    slides = sorted(str(p) for p in slide_dir.glob("*.wsr"))
    xmls = sorted(str(p) for p in slide_dir.glob("*.xml"))
    pairs = match_annotations(slides, xmls)
    assert pairs[0].endswith("slide_00.xml")
    assert pairs[1].endswith("slide_01.xml")
    assert pairs == jax_wsi.match_annotations(slides, xmls)
    assert match_annotations(slides, []) == [None, None]


@pytest.mark.parametrize("ext", ["wsr", "tif"])
def test_train_batches_tumor_quota(slide_dir, ext):
    slides, xmls = _paths(slide_dir, ext)
    kw = dict(tile=32, batch_size=8, batch_tumor_ratio=0.5, stddev_min=5.0)
    sampler = WsiSampler(slides, xmls, SamplerConfig(**kw), worker=0,
                         num_workers=1, seed=1)
    ref = jax_wsi.WsiSampler(slides, xmls, jax_wsi.SamplerConfig(**kw),
                             worker=0, num_workers=1, seed=1)
    got = list(sampler.train_batches(num_batches=4))
    want = list(ref.train_batches(num_batches=4))
    tiles, is_tumor = got[0]
    assert tiles.shape == (8, 32, 32, 3) and tiles.dtype == np.uint8
    assert is_tumor.dtype == bool and is_tumor.sum() == 4
    # Tumor tiles come from inside the annotated square: not white.
    assert tiles[is_tumor].mean() < 230
    assert len(got) == len(want) == 4
    for (t, f), (wt, wf) in zip(got, want):
        assert np.array_equal(t, wt) and np.array_equal(f, wf)


def test_train_batches_without_annotations_match_jax(slide_dir):
    slides, _ = _paths(slide_dir, "wsr")
    kw = dict(tile=64, batch_size=4, batch_tumor_ratio=0.5)
    got = next(WsiSampler(slides, (), SamplerConfig(**kw),
                          seed=7).train_batches())
    want = next(jax_wsi.WsiSampler(slides, (), jax_wsi.SamplerConfig(**kw),
                                   seed=7).train_batches())
    assert not got[1].any()
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])


def test_worker_sharding(slide_dir):
    slides, _ = _paths(slide_dir, "wsr")
    cfg = SamplerConfig(tile=32, batch_size=4)
    s0 = WsiSampler(slides, (), cfg, worker=0, num_workers=2)
    s1 = WsiSampler(slides, (), cfg, worker=1, num_workers=2)
    assert len(s0.paths) == 1 and len(s1.paths) == 1
    assert s0.paths != s1.paths
    jcfg = jax_wsi.SamplerConfig(tile=32, batch_size=4)
    for w, s in ((0, s0), (1, s1)):
        assert s.paths == jax_wsi.WsiSampler(slides, (), jcfg, worker=w,
                                             num_workers=2).paths
    # More workers than slides: wrap around, as in the JAX package.
    s3 = WsiSampler(slides, (), cfg, worker=3, num_workers=4)
    assert s3.paths == jax_wsi.WsiSampler(slides, (), jcfg, worker=3,
                                          num_workers=4).paths
    # No process group: every slide, as JAX's single process sees them.
    assert len(WsiSampler(slides, (), cfg).paths) == 2


@pytest.mark.parametrize("ext", ["wsr", "tif"])
def test_eval_tiles_cover_roi_once(slide_dir, ext):
    slides, _ = _paths(slide_dir, ext)
    sampler = WsiSampler(slides, (), SamplerConfig(tile=64, batch_size=4),
                         worker=0, num_workers=1)
    batches = list(sampler.eval_tiles(0))
    assert batches, "tissue ROI should produce eval tiles"
    allt = np.concatenate(batches)
    assert allt.shape[1:] == (64, 64, 3)
    # Most evaluated tiles contain tissue (non-white).
    means = allt.reshape(len(allt), -1).mean(1)
    assert (means < 250).mean() > 0.7
    ref = jax_wsi.WsiSampler(slides, (), jax_wsi.SamplerConfig(
        tile=64, batch_size=4), worker=0, num_workers=1)
    want = list(ref.eval_tiles(0))
    assert len(batches) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(batches, want))
    # An overlapping stride visits more coordinates, each once.
    strided = WsiSampler(slides, (), SamplerConfig(tile=64, batch_size=4,
                                                   eval_stride=32))
    assert sum(len(b) for b in strided.eval_tiles(1)) > len(allt)


def test_tissue_regions_bboxes(slide_dir):
    slides, _ = _paths(slide_dir, "wsr")
    cfg = SamplerConfig(tile=32, batch_size=4)
    sampler = WsiSampler(slides, (), cfg, worker=0, num_workers=1)
    boxes = sampler.tissue_regions(0)
    assert boxes, "one tissue region expected"
    x, y, w, h = max(boxes, key=lambda b: b[2] * b[3])
    # The tissue block lives at [32:224)x[32:224) of a 256x256 slide.
    assert 0 <= x <= 64 and 0 <= y <= 64
    assert 100 <= w <= 256 and 100 <= h <= 256
    ref = jax_wsi.WsiSampler(slides, (), jax_wsi.SamplerConfig(
        tile=32, batch_size=4), worker=0, num_workers=1)
    for i in range(2):
        assert sampler.tissue_regions(i) == ref.tissue_regions(i)


def test_sampler_shards_slides_over_a_gloo_world(slide_dir, tmp_path):
    """Under a 2-rank process group the sampler's defaults are the rank
    and the world size: each rank streams its slide, the JAX sampler's
    bytes for that worker."""
    slides, xmls = _paths(slide_dir, "wsr")
    outs = run_world("wsi", 2, tmp_path, dict(slides=slides, xmls=xmls))
    kw = dict(tile=32, batch_size=8, batch_tumor_ratio=0.5, stddev_min=5.0)
    for r, o in enumerate(outs):
        ref = jax_wsi.WsiSampler(slides, xmls, jax_wsi.SamplerConfig(**kw),
                                 worker=r, num_workers=2, seed=1)
        assert str(o["paths"]) == ref.paths[0]
        want = list(ref.train_batches(num_batches=2))
        assert np.array_equal(o["tiles"], np.stack([t for t, _ in want]))
        assert np.array_equal(o["flags"], np.stack([f for _, f in want]))
        assert np.array_equal(o["eval"], np.concatenate(
            list(ref.eval_tiles(0))))
    assert str(outs[0]["paths"]) != str(outs[1]["paths"])
