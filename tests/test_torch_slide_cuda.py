"""Whole-slide deployment on the card: ``normalize_slide``'s four kernel
routes (K3 in slide mode; K1, K2, K5 in tile mode) against the kernels'
plain versions, the prefetch ring on the card, and the device work of the
slide-mode stream.

Needs a CUDA device (marker ``cuda``; every test skips without one). The
card has no jax, so this file imports only torch, numpy and the port. On
the card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_slide_cuda.py

The TIFF writer is replaced by a recorder of the levels it is given, so the
tests run on a host without libtiff; the written level 0 is that canvas.
Tolerances: the routes' level 0 equals the plain versions byte for byte
(every kernel equals its plain version since PR 3).
"""

import math

import numpy as np
import pytest
import torch

from stainlib_tpu_torch.data import native
from stainlib_tpu_torch.data.pipeline import DevicePrefetcher
from stainlib_tpu_torch.kernels import macenko_fused as mf
from stainlib_tpu_torch.kernels import reinhard_fused as rf
from stainlib_tpu_torch.kernels import vahadane_fused as vf
from stainlib_tpu_torch.normalization import extractive, reinhard
from stainlib_tpu_torch.normalization import slide as sl
from synth import he_batch, he_patch

W, H, TILE, BATCH = 600, 700, 256, 4  # 9 tiles: two full batches and one


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def slide_path(tmp_path):
    tl = he_batch(9, TILE, TILE, seed=70, background_frac=0.0)
    lv0 = np.concatenate([np.concatenate(list(tl[r * 3:r * 3 + 3]), axis=1)
                          for r in range(3)], axis=0)[:H, :W]
    lv0[:16] = 255
    path = str(tmp_path / "slide.wsiraw")
    native.write_wsiraw(path, [lv0])
    return path


@pytest.fixture
def written(monkeypatch):
    """The levels ``normalize_slide`` hands the writer, which is not run."""
    levels = []
    monkeypatch.setattr(sl, "write_tiff_pyramid",
                        lambda path, lv, **kw: levels.append(lv))
    return levels


def _grid(path):
    s = native.open_slide(path)
    coords = sl._grid_coords(W, H, TILE)
    tiles = np.stack([s.read_region(0, x, y, TILE, TILE) for x, y in coords])
    s.close()
    return coords, tiles


def _assemble(coords, tiles):
    canvas = np.empty((H, W, 3), np.uint8)
    for (x, y), t in zip(coords, tiles):
        h, w = min(TILE, H - y), min(TILE, W - x)
        canvas[y:y + h, x:x + w] = t[:h, :w]
    return canvas


def _launches():
    return dict(K3=mf.matrix_launches, K1=mf.launches, K2=vf.launches,
                K5=rf.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("route,method,estimation", [
    ("K3", "macenko", "slide"), ("K1", "macenko", "tile"),
    ("K2", "vahadane", "tile"), ("K5", "reinhard", "tile")])
def test_routes_equal_plain_versions(cuda, slide_path, written, route,
                                     method, estimation):
    target = torch.from_numpy(he_patch(TILE, TILE, seed=71)).to(cuda)
    tp = (reinhard.fit(target) if method == "reinhard"
          else extractive.fit(target, method=method))
    before = _launches()
    info = sl.normalize_slide(slide_path, "unused.tif", tp, method=method,
                              estimation=estimation, batch=BATCH,
                              device=cuda)
    after = _launches()
    assert info["fused"] is True and info["tiles"] == 9
    assert {k: after[k] - before[k] for k in after} == {
        k: (math.ceil(9 / BATCH) if k == route else 0) for k in after}
    coords, tiles = _grid(slide_path)
    x = torch.from_numpy(tiles).to(cuda)
    if route == "K3":
        src = sl.fit_slide(slide_path, device=cuda)
        plain = mf.normalize_with_matrix_ref(x, src.stain_matrix, src.max_c,
                                             *tp)
    else:
        ref = dict(K1=mf.macenko_normalize_ref, K2=vf.vahadane_normalize_ref,
                   K5=rf.reinhard_normalize_ref)[route]
        plain = ref(x, *tp)
    level0 = written[-1][0]
    assert level0.shape == (H, W, 3)
    assert np.array_equal(level0, _assemble(coords, plain.cpu().numpy()))


@pytest.mark.cuda
def test_prefetcher_on_the_card(cuda):
    """Order across workers, values and placement, a consumer on a side
    stream, and the copy stream's events."""
    batches = [np.full((8, 64, 64, 3), i, np.uint8) for i in range(12)]
    side = torch.cuda.Stream()
    got = []
    with torch.cuda.stream(side):
        for b in DevicePrefetcher(iter(batches), depth=3, workers=3,
                                  device=cuda):
            assert b.device.type == "cuda" and b.dtype == torch.uint8
            got.append((b.float() * 2).sum().item() / (8 * 64 * 64 * 3 * 2))
    assert got == list(range(12))
    pairs = list(DevicePrefetcher(
        iter([(np.arange(6, dtype=np.float32), {"k": np.int64(i)})
              for i in range(4)]), depth=2, device=cuda))
    assert [int(d["k"]) for _, d in pairs] == list(range(4))
    assert all(torch.equal(a.cpu(), torch.arange(6, dtype=torch.float32))
               for a, _ in pairs)


@pytest.mark.cuda
def test_slide_stream_is_one_launch_per_batch(cuda, slide_path):
    """A profiler trace of the slide-mode stream (three batches): per
    batch one copy in, K3, one copy out, and no other device work (no
    ``cat``, ``fill`` or ``copy_`` of the parameters)."""
    from torch.profiler import ProfilerActivity, profile

    tp = extractive.fit(torch.from_numpy(he_patch(TILE, TILE,
                                                  seed=71)).to(cuda))
    src = sl.fit_slide(slide_path, device=cuda)
    apply_fn, fused = sl._make_apply("macenko", "slide", tp, src, TILE, 0.01,
                                     cuda)
    assert fused
    s = native.open_slide(slide_path)
    args = (s, 0, TILE, BATCH, W, H, lambda b, _i: apply_fn(b), None, 3, 2)
    sl._stream_canvas(*args, device=cuda)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        canvas, n = sl._stream_canvas(*args, device=cuda)
        torch.cuda.synchronize()
    s.close()
    acts = {e.key: e.count for e in prof.key_averages()
            if getattr(e, "device_time_total", 0.0) > 0}
    if not acts:
        pytest.skip("the profiler recorded no device activity")
    kinds = {"K3": 0, "HtoD": 0, "DtoH": 0}
    for name, count in acts.items():
        kind = ("K3" if "matrix_apply_kernel" in name else "HtoD"
                if name.startswith("Memcpy HtoD") else "DtoH"
                if name.startswith("Memcpy DtoH") else name)
        assert kind in kinds, f"unexpected device work: {name}"
        kinds[kind] += count
    assert all(1 <= c <= 3 for c in kinds.values()), kinds
