"""The port's reference-scale slide drive (``scripts/torch_bench_wsi_scale.py``)
and host-ingestion benchmark (``scripts/torch_bench_host_ingestion.py``)
against the JAX package's scripts and ``normalize_slide``, on the CPU.

* ``synth_level0`` and ``_target``: byte-equal to JAX's.
* The drive at a small side with ``_RAM_CANVAS_BYTES`` lowered on both
  packages' ``slide`` modules, so level 0's canvas is a disk memmap on
  both: the port's canvas against JAX's ``normalize_slide`` on the same
  WSIRAW input, held as ``tests/test_torch_slide.py`` holds slide mode:
  one estimate (JAX's slide fit and target fit, carried over by
  ``convert``), then bytes at most 1 uint8 step apart on under 0.1% of
  them.
* ``--no-write`` reports the write as null; without libtiff and without
  ``--no-write`` the script stops before it generates anything.
* The ingestion script's JSON for both containers, its keys JAX's plus
  ``container``.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stainlib_tpu.data import native as jax_native  # noqa: E402
from stainlib_tpu.normalization import extractive as jax_ex  # noqa: E402
from stainlib_tpu.normalization import slide as jax_slide  # noqa: E402
from stainlib_tpu_torch import convert  # noqa: E402
from stainlib_tpu_torch.data import native  # noqa: E402
from stainlib_tpu_torch.normalization import slide  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

requires_tiff = pytest.mark.skipif(
    not native.tiff_native_available(), reason="libtiff toolchain missing")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_scale_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


scale = _load("torch_bench_wsi_scale")
jax_scale = _load("bench_wsi_scale")
ingest = _load("torch_bench_host_ingestion")
jax_ingest = _load("bench_host_ingestion")

SIDE, TILE, BATCH = 640, 128, 4  # 25 tiles, 7 batches (the last padded)


def _args(tmp_path, **kw):
    a = scale.parse_args(["--side", str(SIDE), "--tile", str(TILE),
                          "--batch", str(BATCH), "--container", "wsiraw",
                          "--device", "cpu",
                          "--workdir", str(tmp_path / "work")])
    for k, v in kw.items():
        setattr(a, k, v)
    return a


@pytest.mark.parametrize("side,tile,seed", [(600, 256, 0), (333, 64, 5)])
def test_synth_and_target_equal_jax(side, tile, seed):
    got = scale.synth_level0(side, tile, seed)
    assert got.shape == (side, side, 3) and got.dtype == np.uint8
    assert np.array_equal(got, jax_scale.synth_level0(side, tile, seed))
    assert np.array_equal(scale._target(), jax_scale._target())


def test_defaults_match_jax():
    got, want = vars(scale.parse_args([])), vars(jax_scale.parse_args([]))
    for k, v in want.items():
        if k != "workdir":  # the port's follows TMPDIR
            assert got[k] == v, k
    assert got["container"] == "svs" and got["no_write"] is False
    assert got["device"] == "cuda" and got["batch"] == 128


def test_memmap_drive_matches_jax_normalize_slide(tmp_path, monkeypatch):
    monkeypatch.setattr(slide, "_RAM_CANVAS_BYTES", 1 << 10)
    monkeypatch.setattr(jax_slide, "_RAM_CANVAS_BYTES", 1 << 10)
    src = tmp_path / "work" / "scale_in.wsiraw"
    src.parent.mkdir()
    native.write_wsiraw(str(src), [scale.synth_level0(SIDE, TILE, 0)])
    # One estimate on both sides: JAX's target and slide fits.
    jt = jax_ex.fit(jnp.asarray(scale._target()), method="macenko")
    js = jax_slide.fit_slide(str(src), tile=TILE)
    monkeypatch.setattr(scale, "_target", lambda: convert.params_from_jax(
        np.asarray(jt.stain_matrix_target), np.asarray(jt.max_c_target),
        "cpu"))
    monkeypatch.setattr(slide, "fit_slide", lambda *a, **k:
                        convert.slide_params_from_jax(js, "cpu"))
    summary, canvas = scale.drive(_args(tmp_path, keep=True, no_write=True))
    assert summary["canvas"] == "memmap" and isinstance(canvas, np.memmap)
    assert summary["tiles"] == 25 and summary["fused"] is False
    assert summary["estimation"] == "slide" and summary["out_gb"] is None
    parts = summary["parts_s"]
    assert parts["write"] is None
    assert all(parts[k] is not None and parts[k] >= 0
               for k in ("fit", "stream", "pyramid"))
    assert summary["tiles_per_s_steady"] > 0 and summary["peak_rss_gb"] > 0
    assert src.exists()  # --keep

    allocated = []
    real = jax_slide._alloc_u8
    monkeypatch.setattr(jax_slide, "_alloc_u8",
                        lambda shape: allocated.append(real(shape))
                        or allocated[-1])
    out = str(tmp_path / "jax.tif")
    monkeypatch.setattr(jax_slide, "fit_slide", lambda *a, **k: js)
    jax_slide.normalize_slide(str(src), out, jt, tile=TILE, batch=BATCH,
                              compression="none")
    assert isinstance(allocated[0], np.memmap)
    s = jax_native.TiffSlide(out)
    want = s.read_region(0, 0, 0, SIDE, SIDE)
    s.close()
    d = np.abs(np.asarray(canvas).astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(),
                                                    (d > 0).mean())
    assert canvas[:TILE // 2].min() >= 250  # the white margin stays white


@requires_tiff
def test_write_runs_without_no_write(tmp_path):
    summary, canvas = scale.drive(_args(tmp_path, side=384, tile=128))
    assert summary["out_gb"] is not None and summary["canvas"] == "ram"
    assert summary["parts_s"]["write"] is not None
    assert not (tmp_path / "work" / "scale_in.wsiraw").exists()  # no --keep
    assert json.loads((tmp_path / "work" / "wsi_scale.json").read_text()
                      ) == summary


@pytest.mark.parametrize("container,no_write", [
    ("wsiraw", False), ("svs", True), ("svs", False)])
def test_without_libtiff_stops_before_generating(tmp_path, monkeypatch,
                                                 container, no_write):
    monkeypatch.setattr(native, "tiff_native_available", lambda: False)
    with pytest.raises(SystemExit, match="no libtiff"):
        scale.drive(_args(tmp_path, container=container, no_write=no_write))
    assert not (tmp_path / "work").exists()


def _json_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("container", [
    "wsiraw", pytest.param("svs", marks=requires_tiff)])
def test_ingestion_json(capsys, container):
    argv = ["--size", "1024", "--n", "16", "--threads", "1,2",
            "--container", container]
    assert ingest.main(argv) == 0
    got = _json_line(capsys.readouterr().out)
    assert got["container"] == container and got["tile"] == 256
    assert got["host_cores"] == os.cpu_count()
    rows = got["by_threads"]
    for row in rows.values():
        assert row["sample_tiles_tps"] > 0 and row["read_regions_tps"] > 0
    if container == "svs":
        assert jax_ingest.main(argv[:-2]) == 0
        want = _json_line(capsys.readouterr().out)
        assert set(got) == set(want) | {"container"}
        assert got["jpeg_size"] == want["jpeg_size"] == 1024
        assert set(rows) == set(want["by_threads"]) == {"1", "2"}
    else:  # one row, at the reader's own thread count
        assert got["raw_size"] == 1024
        assert list(rows) == [str(os.cpu_count())]


def test_ingestion_svs_without_libtiff_is_jax_error(capsys, monkeypatch):
    monkeypatch.setattr(native, "tiff_native_available", lambda: False)
    monkeypatch.setattr(jax_native, "tiff_native_available", lambda: False)
    assert jax_ingest.main([]) == 1
    want = capsys.readouterr().out
    assert ingest.main([]) == 1
    assert capsys.readouterr().out == want


def test_eval_path_reads_what_the_stream_reads(tmp_path):
    """The WSIRAW eval path stacks one ``read_region`` per tile, as
    ``_stream_canvas`` does; TIFF's batched call gives the same tiles."""
    path = str(tmp_path / "b.wsiraw")
    ingest.make_raw_slide(path, 512)
    s = native.RawSlide(path)
    coords = np.array([[0, 0], [100, 37], [256, 256]], np.int64)
    got = ingest._read_batch(s, coords, 128)
    for (x, y), t in zip(coords, got):
        assert np.array_equal(t, s.read_region(0, int(x), int(y), 128, 128))
    assert np.array_equal(got[0], ingest._levels(512)[0][:128, :128])
    s.close()
