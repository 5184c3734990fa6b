"""Whole-slide stain normalization: stream a WSI through the card, write a WSI.

Port of the JAX package's ``normalization/slide.py``. The
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

``flow_normalize_slide`` deploys the trained flow + GMM colour model the
same way (``slide.py:450-628``): slide-level source statistics, then the
per-class transfer of ``models.color_eval`` on every tile, each batch
through the batch entry ``normalization.flow.FlowNormalizer``.

Every public function takes a ``device``, ``"cuda"`` unless the caller asks
for the CPU. The kernels run on a CUDA device for tiles the JAX package's
kernels take (``tile**2`` a multiple of 128, at most 512**2); otherwise, and
on the CPU, the functional path runs, as it does in the JAX package off the
TPU. The JAX signatures' ``interpret`` (TPU only) has no counterpart here.

Scale-out: with a ``mesh`` (``parallel.mesh.make_mesh``), every rank reads
the same host batches, copies and normalizes only its rows (the batch
sharded over ``mesh_axis``) on its route, and all-gathers the rows along
that axis, so every rank fills the whole canvas; the first rank of the
mesh writes the TIFF. The bytes equal the single-device path's: every
route works tile by tile (K3 and the slide-mode functional paths pixel by
pixel), so no tile's result depends on which rank holds it.
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
from stainlib_tpu_torch.normalization.flow import FLOW_TRANSFERS, FlowNormalizer
from stainlib_tpu_torch.ops.percentile import percentile
from stainlib_tpu_torch.parallel.collectives import all_gather_metrics

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
                tile: int, regularizer: float, device="cuda", mesh=None,
                mesh_axis: str = "data"):
    """Returns ((B, t, t, 3) uint8 -> (B, t, t, 3) uint8 on ``device``,
    fused: bool); ``fused`` reports whether the branch taken runs a kernel.

    The target's and the slide's values move to the device once, as
    float32 tensors; the kernels take them by pointer, so a batch is one
    launch. Every kernel reads the interleaved tiles as they come: there
    is no planar transpose.

    With ``mesh`` set, the function takes this rank's rows of the batch
    (the prefetcher's shard over ``mesh_axis``), normalizes them and
    returns the whole batch, all-gathered along ``mesh_axis``: the
    counterpart of the JAX package's ``shard_map`` over that axis."""
    apply, fused = _make_core(method, estimation, target_params, src, tile,
                              regularizer, torch.device(device))
    if mesh is None:
        return apply, fused
    return (lambda b: all_gather_metrics(apply(b), mesh, mesh_axis)), fused


def _make_core(method, estimation, target_params, src, tile, regularizer,
               dev):
    """:func:`_make_apply`'s route on one device."""
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
                   prefetch_workers: int, device="cuda", mesh=None,
                   mesh_axis: str = "data"):
    """Stream the tile grid through ``apply_fn(dev_batch, batch_index)``
    (threaded decode -> prefetch ring -> device -> host) into an
    (H, W, 3) canvas; returns (canvas, number of tiles). With ``mesh``,
    the ring copies only this rank's rows of each batch (``apply_fn``
    returns the whole batch)."""
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
                          workers=prefetch_workers, device=device, mesh=mesh,
                          mesh_axis=mesh_axis)
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
    mesh=None,
    mesh_axis: str = "data",
) -> dict:
    """Normalize every tile of a WSI toward ``target`` and write a tiled
    pyramidal TIFF. Returns a summary dict (dims, tiles, modes, and
    ``fused``: whether the tiles went through a kernel).

    ``target``: an (H, W, 3) uint8 target image, a path to one, or
    pre-fitted params (``ExtractiveParams`` / ``ReinhardParams``).
    ``estimation``: 'slide' (one stain estimate for the whole slide;
    seam-free, fastest) or 'tile' (the reference's per-patch re-estimation,
    ``normalizer.py:45-48``). ``device``: where the fit and the tiles run.
    ``mesh``: an optional ``DeviceMesh`` (every rank of it calls this with
    the same arguments): tile batches are sharded over ``mesh_axis``, each
    rank normalizes its rows, and the first rank of the mesh writes the
    output, bit-identical to the single-device path's. ``batch`` must be a
    multiple of the mesh's ``mesh_axis`` axis size.
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

        if mesh is not None:
            names = mesh.mesh_dim_names or ()
            if mesh_axis not in names:
                raise ValueError(
                    f"mesh_axis {mesh_axis!r} not in mesh axes "
                    f"{tuple(names)}")
            # Divisibility is against the SHARDED axis, not the total
            # device count: on a multi-axis mesh the batch only splits
            # over mesh_axis (other axes replicate the shard).
            axis_size = mesh.size(names.index(mesh_axis))
            if batch % axis_size:
                raise ValueError(
                    f"batch ({batch}) must be a multiple of the mesh's "
                    f"{mesh_axis!r} axis size ({axis_size})")

        apply_fn, fused = _make_apply(method, estimation, target_params, src,
                                      tile, regularizer, dev, mesh=mesh,
                                      mesh_axis=mesh_axis)
        canvas, n_tiles = _stream_canvas(
            slide, level, tile, batch, W, H,
            lambda dev_batch, _bi: apply_fn(dev_batch), progress,
            prefetch_depth, prefetch_workers, device=dev, mesh=mesh,
            mesh_axis=mesh_axis)

        levels = build_pyramid(canvas, min_dim=min_pyramid)
        if mesh is None or mesh.get_rank() == int(mesh.mesh.flatten()[0]):
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


def flow_normalize_slide(
    src_path: str,
    out_path: str,
    ckpt_dir: str,
    template=None,
    batch: int = 8,
    level: int = 0,
    n_src_tiles: int = 32,
    seed: int = 0,
    min_pyramid: int = 512,
    compression: str = "jpeg",
    quality: int = 90,
    prefetch_depth: int = 3,
    prefetch_workers: int = 2,
    progress: Optional[Callable[[int, int], None]] = None,
    cfg=None,
    use_ema: bool = True,
    class_match: bool = False,
    transfer: str = "diag",
    device="cuda",
) -> dict:
    """Whole-slide colour normalization with the trained residual flow +
    GMM: the ``validate`` / deploy loop of ``train_img_horo.py:658-930``
    (template statistics, then the per-class HSD transfer of ``:815``)
    applied to every tile of a WSI, written back as a pyramidal TIFF.

    ``ckpt_dir``: a ``utils/checkpoint.py`` directory of this package (a
    ``.pt`` state; the JAX package's checkpoints are not read) holding the
    training state of ``cfg`` (default ``reference_capacity()``, 502,855
    parameters; ``scripts/torch_train_flow_capacity.py``). ``template``:
    (N, S, S, 3) uint8 template tiles, a template slide to sample them
    from, or None for the synthetic center 0 (``data.synthetic``). The EMA
    weights deploy by default (the reference's ``--ema-val`` swap,
    ``train_img_horo.py:668-669``).

    The source statistics come once from ``n_src_tiles`` sampled tissue
    tiles of the whole slide (not per batch, ``:803-812``), so every tile
    goes through one slide-level map and the output has no batch seams;
    ``class_match`` takes one slide-level permutation (usage-rank
    matching). ``transfer``: 'diag' (the reference's affine), 'full'
    (Monge maps), 'quantile' or 'rgb-quantile' (quantile matching in HSD
    or float RGB); see ``models.color_eval``. ``device``: where the model
    and the tiles run."""
    from stainlib_tpu_torch.data.synthetic import center_tiles
    from stainlib_tpu_torch.models.train_flow import (
        init_flow_state, reference_capacity)
    from stainlib_tpu_torch.ops.colorspace import rgb_to_hsd
    from stainlib_tpu_torch.utils.checkpoint import restore_checkpoint

    if transfer not in FLOW_TRANSFERS:
        raise ValueError(f"transfer must be one of {FLOW_TRANSFERS}, "
                         f"got {transfer!r}")
    dev = _device(device)
    if cfg is None:
        cfg = reference_capacity()
    tile = cfg.image_size

    # Template tiles, uint8 on the device.
    if template is None:
        template = center_tiles(0, max(batch * 4, 32), tile, tile,
                                seed=seed + 100)
    elif isinstance(template, (str, bytes)):
        t_slide, _ = _open(template)
        try:
            template, _ = t_slide.sample_tiles(level, tile,
                                               max(batch * 4, 32),
                                               seed=seed + 100)
        finally:
            t_slide.close()
    tmpl = torch.from_numpy(np.ascontiguousarray(template)).to(dev)

    _, _, state, _ = init_flow_state(
        cfg, seed, sample_hsd=rgb_to_hsd(tmpl[:batch]), device=dev)
    state = restore_checkpoint(ckpt_dir, state)
    params = state.ema.params if use_ema else state.params
    norm = FlowNormalizer(cfg, params, state.spectral, transfer=transfer,
                          class_match=class_match)

    def batches(tiles):
        return [tiles[i:i + batch] for i in range(0, len(tiles), batch)]

    norm.fit(batches(tmpl))
    slide, _ = _open(src_path)
    try:
        W, H = slide.level_size(level)
        # Slide-level source statistics from sampled tissue tiles; the slots
        # where rejection sampling failed (coords -1) are dropped, as in
        # _sample_mosaic.
        src_tiles, src_xy = slide.sample_tiles(level, tile, n_src_tiles,
                                               seed=seed)
        kept = src_tiles[src_xy[:, 0] >= 0]
        if len(kept):
            src_tiles = kept
        norm.fit_source(batches(torch.from_numpy(
            np.ascontiguousarray(src_tiles)).to(dev)))

        def recolor(batch_u8, _bi):
            # The JAX package folds the batch index into a key per batch for
            # the logdet's probes; gamma never reads them, and the
            # gamma-only route draws none, so no per-batch generator.
            return norm.transform(batch_u8)

        canvas, n_tiles = _stream_canvas(
            slide, level, tile, batch, W, H, recolor, progress,
            prefetch_depth, prefetch_workers, device=dev)

        levels = build_pyramid(canvas, min_dim=min_pyramid)
        write_tiff_pyramid(out_path, levels, tile=tile,
                           compression=compression, quality=quality)
        return {
            "width": W, "height": H, "tiles": n_tiles,
            "levels": len(levels), "method": "flow",
            "params": int(sum(p.numel() for part in params.values()
                              for p in part.values())),
            "step": int(state.step),
            "ema": use_ema,
        }
    finally:
        slide.close()
