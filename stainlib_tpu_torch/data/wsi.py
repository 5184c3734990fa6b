"""Whole-slide-image streaming sampler.

Port of the JAX package's ``data/wsi.py``, itself the re-design of the
reference's "SurfSampler" (``dlmodels/color-information/data_utils.py:1``,
class ``make_dataset``): glob WSIs and annotation files, match them by name
similarity, shard slides per worker, detect tissue ROIs on a downsampled
level (HSV in-range + close/open morphology), rasterize ASAP-XML tumor
polygons to level-0 masks, and stream tiles: random tissue/tumor-quota
sampling with low-variance rejection in train mode, exhaustive ROI grids
with visited-tracking in eval mode.

Host code in numpy that returns numpy, as in the JAX package. The hot paths
(region copy, rejection sampling, morphology) run in the port's copy of the
C++ core (:mod:`stainlib_tpu_torch.data.native`), so one seed gives the
JAX sampler's bytes; this module is orchestration only. Slides are WSIRAW
pyramids or tiled pyramidal TIFF. A device prefetcher
(:class:`stainlib_tpu_torch.data.pipeline.DevicePrefetcher`) carries the
batches to the card.
"""

from __future__ import annotations

import dataclasses
import difflib
import glob as globlib
import os
import xml.etree.ElementTree as ET
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from stainlib_tpu_torch.data.native import (
    RawSlide,
    open_slide,
    tissue_mask_hsv,
)
from stainlib_tpu_torch.parallel.mesh import local_data_shard


def match_annotations(slide_paths: Sequence[str],
                      xml_paths: Sequence[str]) -> List[Optional[str]]:
    """Pair each slide with its closest-named annotation file (the
    reference's difflib string-similarity matching, ``data_utils.py:1``)."""
    out: List[Optional[str]] = []
    names = [os.path.splitext(os.path.basename(p))[0] for p in xml_paths]
    for sp in slide_paths:
        stem = os.path.splitext(os.path.basename(sp))[0]
        best = difflib.get_close_matches(stem, names, n=1, cutoff=0.1)
        out.append(xml_paths[names.index(best[0])] if best else None)
    return out


def parse_asap_xml(path: str) -> List[np.ndarray]:
    """ASAP annotation XML -> list of (N, 2) level-0 polygon vertex arrays
    (``parse_xml`` in ``data_utils.py:1``)."""
    root = ET.parse(path).getroot()
    polys = []
    for ann in root.iter("Annotation"):
        pts = [
            (float(c.get("X")), float(c.get("Y")))
            for c in ann.iter("Coordinate")
        ]
        if len(pts) >= 3:
            polys.append(np.asarray(pts, np.float64))
    return polys


def rasterize_polygons(polys: Sequence[np.ndarray], height: int, width: int,
                       scale: float = 1.0) -> np.ndarray:
    """Even-odd-rule polygon rasterization to a bool mask at ``scale`` times
    the level-0 coordinates (the XML -> mask step of ``data_utils.py:1``)."""
    mask = np.zeros((height, width), bool)
    yy = (np.arange(height) + 0.5) / scale
    for poly in polys:
        x = poly[:, 0] * 1.0
        y = poly[:, 1] * 1.0
        x0 = max(int(np.floor(x.min() * scale)), 0)
        x1 = min(int(np.ceil(x.max() * scale)) + 1, width)
        if x0 >= x1:
            continue
        xs_grid = (np.arange(x0, x1) + 0.5) / scale
        # Scanline even-odd counting, vectorized over rows.
        y0 = max(int(np.floor(y.min() * scale)), 0)
        y1 = min(int(np.ceil(y.max() * scale)) + 1, height)
        for r in range(y0, y1):
            py = yy[r]
            x_cross = []
            n = len(x)
            for i in range(n):
                xa, ya = x[i], y[i]
                xb, yb = x[(i + 1) % n], y[(i + 1) % n]
                if (ya <= py) != (yb <= py):
                    x_cross.append(xa + (py - ya) * (xb - xa) / (yb - ya))
            if not x_cross:
                continue
            x_cross = np.sort(np.asarray(x_cross))
            inside = np.searchsorted(x_cross, xs_grid) % 2 == 1
            mask[r, x0:x1] |= inside
    return mask


@dataclasses.dataclass
class SamplerConfig:
    """The sampling knobs of ``make_dataset`` (``data_utils.py:1``)."""

    tile: int = 256
    batch_size: int = 16
    batch_tumor_ratio: float = 0.5
    white_mean_max: float = 230.0
    stddev_min: float = 15.0
    mask_level: int = -1  # downsampled level for ROI detection (-1 = last)
    eval_stride: Optional[int] = None  # defaults to tile (non-overlapping)


class WsiSampler:
    """Streams tile batches from a set of slides (WSIRAW or tiled
    pyramidal TIFF / .svs, via
    :func:`stainlib_tpu_torch.data.native.open_slide`).

    * per-worker sharding of the slide list mirrors the reference's
      ``hvd.rank()`` split (``data_utils.py:1``); ``worker`` and
      ``num_workers`` default to the process group's rank and size (0 and
      1 without a group);
    * train mode: random tiles with tumor-quota (``batch_tumor_ratio``),
      HSV-morphology tissue gating and white/low-variance rejection;
    * eval mode: exhaustive non-overlapping grid over the tissue ROI with
      visited-coordinate tracking (the ``tester`` contract).
    """

    def __init__(self, slide_paths: Sequence[str],
                 xml_paths: Sequence[str] = (),
                 cfg: SamplerConfig = SamplerConfig(),
                 worker: Optional[int] = None,
                 num_workers: Optional[int] = None,
                 seed: int = 0):
        if isinstance(slide_paths, str):
            slide_paths = sorted(globlib.glob(slide_paths))
        if isinstance(xml_paths, str):
            xml_paths = sorted(globlib.glob(xml_paths))
        lo, hi = local_data_shard(len(slide_paths), worker, num_workers)
        if hi <= lo:  # fewer slides than workers: wrap around
            lo, hi = (worker or 0) % max(len(slide_paths), 1), None
            hi = lo + 1
        self.paths = list(slide_paths[lo:hi])
        self.xmls = (match_annotations(self.paths, xml_paths)
                     if xml_paths else [None] * len(self.paths))
        self.cfg = cfg
        self.seed = seed
        self._slides = [open_slide(p) for p in self.paths]
        self._masks = [self._roi_mask(s) for s in self._slides]
        self._tumor = [self._tumor_mask(s, x)
                       for s, x in zip(self._slides, self.xmls)]

    # -- masks ------------------------------------------------------------

    def _mask_level(self, slide: RawSlide) -> int:
        ml = self.cfg.mask_level
        return slide.num_levels - 1 if ml < 0 else ml

    def _roi_mask(self, slide: RawSlide) -> Tuple[np.ndarray, float]:
        """(mask over the downsampled level, scale from level-0 coords)."""
        ml = self._mask_level(slide)
        w, h = slide.level_size(ml)
        img = slide.read_region(ml, 0, 0, w, h)
        # Luminosity-style gating: anything clearly non-white is candidate
        # tissue; morphology closes gaps (the reference's HSV get_bb).
        mask = tissue_mask_hsv(img, h_range=(0, 180), s_range=(15, 255),
                               v_range=(30, 250), k_close=9, k_open=5)
        w0, h0 = slide.level_size(0)
        return mask, w / w0

    def _tumor_mask(self, slide: RawSlide, xml: Optional[str]):
        if xml is None:
            return None
        polys = parse_asap_xml(xml)
        if not polys:
            return None
        ml = self._mask_level(slide)
        w, h = slide.level_size(ml)
        w0, _ = slide.level_size(0)
        return rasterize_polygons(polys, h, w, scale=w / w0)

    def tissue_regions(self, slide_index: int = 0):
        """Connected tissue regions as level-0 bounding boxes (x, y, w, h) —
        the ``findContours``-based ``get_bb`` output of ``data_utils.py:1``,
        via connected-component labeling on the morphology mask."""
        from scipy import ndimage

        mask, scale = self._masks[slide_index]
        labels, n = ndimage.label(mask)
        boxes = []
        for sl_y, sl_x in ndimage.find_objects(labels):
            x0 = int(sl_x.start / scale)
            y0 = int(sl_y.start / scale)
            w = int((sl_x.stop - sl_x.start) / scale)
            h = int((sl_y.stop - sl_y.start) / scale)
            boxes.append((x0, y0, w, h))
        return boxes

    # -- training stream ---------------------------------------------------

    def train_batches(self, num_batches: Optional[int] = None) -> Iterator:
        """Yield (tiles (B, t, t, 3) uint8, is_tumor (B,) bool) batches."""
        cfg = self.cfg
        step = 0
        rng = np.random.default_rng(self.seed)
        while num_batches is None or step < num_batches:
            idx = int(rng.integers(0, len(self._slides)))
            slide = self._slides[idx]
            mask, scale = self._masks[idx]
            tumor = self._tumor[idx]
            n_tumor = (int(round(cfg.batch_size * cfg.batch_tumor_ratio))
                       if tumor is not None else 0)
            parts = []
            flags = []
            if n_tumor:
                t_tiles, t_coords = slide.sample_tiles(
                    0, cfg.tile, n_tumor, seed=int(rng.integers(2**63)),
                    white_mean_max=cfg.white_mean_max,
                    stddev_min=cfg.stddev_min, mask=tumor, mask_scale=scale,
                )
                parts.append(t_tiles)
                flags.append(np.ones(n_tumor, bool))
            n_rest = cfg.batch_size - n_tumor
            r_tiles, _ = slide.sample_tiles(
                0, cfg.tile, n_rest, seed=int(rng.integers(2**63)),
                white_mean_max=cfg.white_mean_max,
                stddev_min=cfg.stddev_min, mask=mask, mask_scale=scale,
            )
            parts.append(r_tiles)
            flags.append(np.zeros(n_rest, bool))
            yield np.concatenate(parts), np.concatenate(flags)
            step += 1

    # -- evaluation stream ---------------------------------------------------

    def eval_tiles(self, slide_index: int = 0) -> Iterator[np.ndarray]:
        """Exhaustive grid over the tissue ROI, each coordinate visited once
        (the tester's visited-coords contract), in batches of
        ``cfg.batch_size`` (last batch padded by repetition)."""
        cfg = self.cfg
        slide = self._slides[slide_index]
        mask, scale = self._masks[slide_index]
        stride = cfg.eval_stride or cfg.tile
        W, H = slide.level_size(0)
        coords = []
        for y in range(0, H - cfg.tile + 1, stride):
            for x in range(0, W - cfg.tile + 1, stride):
                mx = min(int((x + cfg.tile // 2) * scale), mask.shape[1] - 1)
                my = min(int((y + cfg.tile // 2) * scale), mask.shape[0] - 1)
                if mask[my, mx]:
                    coords.append((x, y))
        for i in range(0, len(coords), cfg.batch_size):
            chunk = coords[i : i + cfg.batch_size]
            while len(chunk) < cfg.batch_size:
                chunk.append(chunk[-1])
            if hasattr(slide, "read_regions"):
                # One C call per batch: regions decode concurrently across
                # the slide's handle pool (tf_read_regions), matching the
                # train-mode sampler's threading instead of one serial
                # decode per coordinate.
                yield slide.read_regions(0, np.asarray(chunk, np.int64),
                                         cfg.tile, cfg.tile)
            else:
                yield np.stack([
                    slide.read_region(0, x, y, cfg.tile, cfg.tile)
                    for x, y in chunk
                ])
