"""Whole-slide stain normalization: stream a WSI through the card, write a WSI.

Port of the JAX package's ``normalization/slide.py:40-447``. The
reference's deployment story is the ``tester`` loop: iterate every tile of
a slide through OpenSlide/PyVips decode and a per-patch CPU transform
(``dlmodels/color-information/data_utils.py:1``; per-patch normalization
``stainlib/normalization/normalizer.py:39-50``). Here it is one call:
native decode on host threads (``data/native.py``), a prefetch ring onto
the device (``data/pipeline.py``), the fused CUDA kernels on every tile, and
a tiled pyramidal TIFF written back out.

Estimation modes:

* ``estimation='slide'`` (default): ONE stain matrix + maxC for the whole
  slide, fitted on a mosaic of rejection-sampled tissue tiles, then applied
  to every tile by the fixed-matrix kernel K3
  (``kernels.macenko_fused.normalize_with_matrix``). A slide is one
  staining event, so one estimate is the physically meaningful choice, and
  adjacent tiles share one color map, so the output has no tile seams.
  Reinhard in this mode runs the functional transform with the slide's
  statistics: no kernel, in the JAX package either.
* ``estimation='tile'``: the reference's per-patch semantics (re-estimate
  per tile, ``normalizer.py:45-48``) through the per-tile kernels K1
  (Macenko), K2 (Vahadane) and K5 (Reinhard) at their default knobs.

Every public function takes a ``device``, ``"cuda"`` unless the caller asks
for the CPU. The kernels run on a CUDA device for tiles the JAX package's
kernels take (``tile**2`` a multiple of 128, at most 512**2); otherwise, and
on the CPU, the functional path runs, as it does in the JAX package off the
TPU. The JAX signatures' ``interpret`` (TPU only) and ``mesh`` /
``mesh_axis`` (the distributed layer) have no counterpart here.
"""

from __future__ import annotations

import math
import os
import tempfile
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from stainlib_tpu_torch.api import _device
from stainlib_tpu_torch.data.native import open_slide, write_tiff_pyramid
from stainlib_tpu_torch.data.pipeline import DevicePrefetcher
from stainlib_tpu_torch.kernels.macenko_fused import (
    macenko_normalize,
    normalize_with_matrix,
)
from stainlib_tpu_torch.kernels.reinhard_fused import reinhard_normalize
from stainlib_tpu_torch.kernels.vahadane_fused import vahadane_normalize
from stainlib_tpu_torch.normalization import extractive, reinhard
from stainlib_tpu_torch.ops.percentile import percentile

# Above this many bytes a canvas/pyramid level is backed by a disk memmap
# instead of host RAM: the reference's ``tester`` deployment iterates 100k+
# tiles per slide (``data_utils.py:1``), i.e. level-0 canvases of tens of
# GB that must not be required to fit in memory.
_RAM_CANVAS_BYTES = 1 << 30


def _alloc_u8(shape):
    """uint8 array of ``shape``: plain RAM below ``_RAM_CANVAS_BYTES``, an
    anonymous disk-backed memmap above (the file is unlinked immediately;
    space is reclaimed when the array is garbage collected)."""
    nbytes = int(np.prod(shape))
    if nbytes <= _RAM_CANVAS_BYTES:
        return np.empty(shape, np.uint8)
    f = tempfile.NamedTemporaryFile(prefix="stainlib_canvas_", delete=False)
    f.close()
    arr = np.memmap(f.name, dtype=np.uint8, mode="w+", shape=shape)
    os.unlink(f.name)
    return arr


class SlideStainParams(NamedTuple):
    """Slide-level source estimate: one stain matrix + 99th-pct maxC,
    float32 tensors on the device they were fitted on."""

    stain_matrix: torch.Tensor  # (2, 3)
    max_c: torch.Tensor  # (2,)


class SlideReinhardParams(NamedTuple):
    """Slide-level Reinhard source estimate: LAB stats + brightness p90."""

    stats: reinhard.ReinhardParams
    brightness_divisor: float


def _open(slide_or_path):
    if isinstance(slide_or_path, (str, bytes)):
        return open_slide(slide_or_path), True
    return slide_or_path, False


def _sample_mosaic(slide, level: int, tile: int, n_tiles: int, seed: int):
    """Rejection-sampled tissue tiles stacked into one tall (n*t, t, 3)
    image: percentiles and covariances over the mosaic ARE statistics over
    the sampled tissue pixels (the white/stddev rejection mirrors the
    reference sampler's background filter, ``data_utils.py:1``)."""
    tiles, coords = slide.sample_tiles(level, tile, n_tiles, seed=seed)
    kept = tiles[(coords[:, 0] >= 0)]
    if len(kept) == 0:  # all-background slide: fall back to whatever came
        kept = tiles
    return kept.reshape(-1, tile, 3)


def _mosaic(slide_or_path, level, tile, n_tiles, seed, dev):
    slide, owned = _open(slide_or_path)
    try:
        mosaic = _sample_mosaic(slide, level, tile, n_tiles, seed)
    finally:
        if owned:
            slide.close()
    return torch.from_numpy(mosaic).to(dev)


def fit_slide(slide_or_path, method: str = "macenko", level: int = 0,
              tile: int = 256, n_tiles: int = 32, seed: int = 0,
              regularizer: float = 0.01, device="cuda",
              **extractor_kwargs) -> SlideStainParams:
    """Estimate one (stain matrix, maxC) for a whole slide from a mosaic of
    rejection-sampled tissue tiles (Macenko or Vahadane), on ``device``.
    The mosaic's pixel count (n_tiles * tile^2, default 2M) takes the
    count-bisection percentiles (``ops/percentile.py``)."""
    mosaic = _mosaic(slide_or_path, level, tile, n_tiles, seed,
                     _device(device))
    p = extractive.fit(mosaic, method=method, regularizer=regularizer,
                       **extractor_kwargs)
    return SlideStainParams(stain_matrix=p.stain_matrix_target.contiguous(),
                            max_c=p.max_c_target.contiguous())


def fit_slide_reinhard(slide_or_path, level: int = 0, tile: int = 256,
                       n_tiles: int = 32, seed: int = 0,
                       quantize: bool = True,
                       device="cuda") -> SlideReinhardParams:
    """Slide-level Reinhard source statistics: the 90th-percentile
    brightness divisor and the post-standardization LAB mean/std of the
    tissue mosaic (the per-image quantities of ``normalizer.py:70-83``
    hoisted to slide scope)."""
    mosaic = _mosaic(slide_or_path, level, tile, n_tiles, seed,
                     _device(device))
    p90 = percentile(mosaic.to(torch.float32).reshape(-1), 90.0, axis=0)
    return SlideReinhardParams(stats=reinhard.fit(mosaic, quantize=quantize),
                               brightness_divisor=float(p90))


def _grid_coords(W: int, H: int, tile: int):
    xs = list(range(0, W, tile))
    ys = list(range(0, H, tile))
    return [(x, y) for y in ys for x in xs]


def _use_fused(tile: int, device) -> bool:
    """The kernels' route: a CUDA device and the JAX package's shape gate
    (``slide.py:155-157``)."""
    return (torch.device(device).type == "cuda"
            and (tile * tile) % 128 == 0 and tile * tile <= 512 * 512)


def _f32(x, dev):
    """A float32 contiguous tensor on ``dev`` (moved once, not per batch)."""
    return torch.as_tensor(x).to(device=dev, dtype=torch.float32).contiguous()


def _make_apply(method: str, estimation: str, target_params, src,
                tile: int, regularizer: float, device="cuda"):
    """Returns ((B, t, t, 3) uint8 -> (B, t, t, 3) uint8 on ``device``,
    fused: bool); ``fused`` reports whether the branch taken runs a kernel.

    The target's and the slide's values move to the device once, as
    float32 tensors; the kernels take them by pointer, so a batch is one
    launch. Every kernel reads the interleaved tiles as they come: there
    is no planar transpose."""
    dev = torch.device(device)
    fused = _use_fused(tile, dev)

    if method == "reinhard":
        tgt = reinhard.ReinhardParams(*(_f32(t, dev) for t in target_params))
        if estimation == "slide":
            # Slide-level source stats: a per-pixel affine with no
            # percentile left for a kernel to win on; the reference route.
            stats = reinhard.ReinhardParams(*(_f32(t, dev)
                                              for t in src.stats))
            div = _f32(src.brightness_divisor, dev)
            return (lambda b: reinhard.transform(
                tgt, b, source_stats=stats, brightness_divisor=div)), False
        if fused:  # per-image source stats (normalizer.py:70-83): K5
            return (lambda b: reinhard_normalize(b, tgt.means,
                                                 tgt.stds)), True
        return (lambda b: reinhard.transform(tgt, b)), False

    tgt = extractive.ExtractiveParams(
        _f32(target_params.stain_matrix_target, dev),
        _f32(target_params.max_c_target, dev))
    M_tgt, mc_tgt = tgt
    if estimation == "slide":
        M_src, mc_src = _f32(src.stain_matrix, dev), _f32(src.max_c, dev)
        if fused:  # K3, its four values by pointer with stride 0
            return (lambda b: normalize_with_matrix(
                b, M_src, mc_src, M_tgt, mc_tgt, regularizer)), True
        return (lambda b: extractive.transform_with_matrix(
            b, M_src, mc_src, tgt, regularizer=regularizer)), False

    # estimation == 'tile': the reference's per-patch semantics, through K1
    # or K2 at the kernels' defaults (slide.py:241-255), not the API's
    # subsampled fit.
    if fused:
        kern = macenko_normalize if method == "macenko" else vahadane_normalize
        return (lambda b: kern(b, M_tgt, mc_tgt)), True
    return (lambda b: extractive.transform(tgt, b, method=method,
                                           regularizer=regularizer)), False


def build_pyramid(level0: np.ndarray, min_dim: int = 512):
    """2x box-mean reduced-resolution levels down to ``min_dim`` (the .svs
    layout the native writer emits; odd trailing rows/cols are cropped,
    matching how scanners truncate). Each level is reduced in row chunks
    (~64 MB of intermediate at a time) and lands in RAM or a disk memmap
    via :func:`_alloc_u8`, so reference-scale slides (tens of GB at level
    0) never need a full-level uint16 temporary in memory."""
    levels = [level0]
    cur = level0
    while min(cur.shape[0] // 2, cur.shape[1] // 2) >= min_dim:
        h2, w2 = cur.shape[0] // 2, cur.shape[1] // 2
        nxt = _alloc_u8((h2, w2, 3))
        step = max(1, (64 << 20) // max(w2 * 12, 1))  # rows per chunk
        for r0 in range(0, h2, step):
            r1 = min(r0 + step, h2)
            c = cur[2 * r0 : 2 * r1, : 2 * w2].astype(np.uint16)
            nxt[r0:r1] = ((c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2]
                           + c[1::2, 1::2] + 2) // 4).astype(np.uint8)
        levels.append(nxt)
        cur = nxt
    return levels


def _stream_canvas(slide, level: int, tile: int, batch: int, W: int, H: int,
                   apply_fn, progress, prefetch_depth: int,
                   prefetch_workers: int, device="cuda"):
    """Stream the tile grid through ``apply_fn(dev_batch, batch_index)``
    (threaded decode -> prefetch ring -> device -> host) into an
    (H, W, 3) canvas; returns (canvas, number of tiles)."""
    coords = _grid_coords(W, H, tile)
    n_batches = math.ceil(len(coords) / batch)
    canvas = _alloc_u8((H, W, 3))
    read_regions = getattr(slide, "read_regions", None)
    # Coordinates stay on the host. The trailing partial batch is padded by
    # repeating its last coordinate, so every batch has one shape; the
    # writer crops through the unpadded chunk.
    chunks = [coords[i * batch : (i + 1) * batch] for i in range(n_batches)]

    def host_batches():
        for chunk in chunks:
            padded = chunk + [chunk[-1]] * (batch - len(chunk))
            if read_regions is not None:  # threaded native batch decode
                yield read_regions(level, np.asarray(padded, np.int64),
                                   tile, tile)
            else:  # WSIRAW mmap slides decode per region
                yield np.stack([
                    slide.read_region(level, int(x), int(y), tile, tile)
                    for x, y in padded])

    pf = DevicePrefetcher(host_batches(), depth=prefetch_depth,
                          workers=prefetch_workers, device=device)
    for bi, dev_batch in enumerate(pf):
        out = apply_fn(dev_batch, bi).cpu().numpy()  # on the compute stream
        for (x, y), img in zip(chunks[bi], out):
            h_v = min(tile, H - y)
            w_v = min(tile, W - x)
            canvas[y : y + h_v, x : x + w_v] = img[:h_v, :w_v]
        if progress is not None:
            progress(bi + 1, n_batches)
    return canvas, len(coords)


def normalize_slide(
    src_path: str,
    out_path: str,
    target,
    method: str = "macenko",
    estimation: str = "slide",
    tile: int = 256,
    batch: int = 64,
    level: int = 0,
    n_fit_tiles: int = 32,
    seed: int = 0,
    regularizer: float = 0.01,
    min_pyramid: int = 512,
    compression: str = "jpeg",
    quality: int = 90,
    prefetch_depth: int = 3,
    prefetch_workers: int = 2,
    progress: Optional[Callable[[int, int], None]] = None,
    device="cuda",
) -> dict:
    """Normalize every tile of a WSI toward ``target`` and write a tiled
    pyramidal TIFF. Returns a summary dict (dims, tiles, modes, and
    ``fused``: whether the tiles went through a kernel).

    ``target``: an (H, W, 3) uint8 target image, a path to one, or
    pre-fitted params (``ExtractiveParams`` / ``ReinhardParams``).
    ``estimation``: 'slide' (one stain estimate for the whole slide;
    seam-free, fastest) or 'tile' (the reference's per-patch re-estimation,
    ``normalizer.py:45-48``). ``device``: where the fit and the tiles run.
    """
    method = method.lower()
    if method not in ("macenko", "vahadane", "reinhard"):
        raise ValueError(f"unknown method {method!r}")
    if estimation not in ("slide", "tile"):
        raise ValueError(f"unknown estimation {estimation!r}")
    dev = _device(device)

    if isinstance(target, (str, bytes)):
        from PIL import Image

        target = np.asarray(Image.open(target).convert("RGB"))
    if isinstance(target, (extractive.ExtractiveParams,
                           reinhard.ReinhardParams)):
        target_params = target
    else:
        t = torch.from_numpy(np.ascontiguousarray(target)).to(dev)
        target_params = (reinhard.fit(t) if method == "reinhard" else
                         extractive.fit(t, method=method,
                                        regularizer=regularizer))

    slide, _ = _open(src_path)
    try:
        W, H = slide.level_size(level)

        src = None
        if estimation == "slide":
            if method == "reinhard":
                src = fit_slide_reinhard(slide, level=level, tile=tile,
                                         n_tiles=n_fit_tiles, seed=seed,
                                         device=dev)
            else:
                src = fit_slide(slide, method=method, level=level, tile=tile,
                                n_tiles=n_fit_tiles, seed=seed,
                                regularizer=regularizer, device=dev)

        apply_fn, fused = _make_apply(method, estimation, target_params, src,
                                      tile, regularizer, dev)
        canvas, n_tiles = _stream_canvas(
            slide, level, tile, batch, W, H,
            lambda dev_batch, _bi: apply_fn(dev_batch), progress,
            prefetch_depth, prefetch_workers, device=dev)

        levels = build_pyramid(canvas, min_dim=min_pyramid)
        write_tiff_pyramid(out_path, levels, tile=tile,
                           compression=compression, quality=quality)
        return {
            "width": W,
            "height": H,
            "tiles": n_tiles,
            "levels": len(levels),
            "method": method,
            "estimation": estimation,
            "fused": fused,
        }
    finally:
        slide.close()
