"""The extractive normalizers (Macenko, Vahadane): the program under test
and its plain reference, as the harness drives them.

The program is ``stainlib_tpu_torch``: the target is fitted by
``normalization.extractive.fit`` (the drop-in ``fit``); a per-tile mix
calls ``kernels.macenko_fused.macenko_normalize`` or
``kernels.vahadane_fused.vahadane_normalize`` with the configuration's
knobs, as ``api.py`` calls them; a per-slide mix fits one estimate on the
mosaic with the same ``fit`` (as ``normalization/slide.fit_slide`` does)
and calls ``kernels.macenko_fused.normalize_with_matrix`` with the values
on the device, as ``normalization/slide._make_core`` routes slide mode.

The reference recomputes every value from the same target tile and mosaic
(``benchmark/reference``) and takes nothing the program made.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from benchmark.reference import ops as ref_ops
from benchmark.reference import planar as ref_planar


class Program(NamedTuple):
    fits: dict  # name -> tensor: the set-up's fitted values
    call: Callable  # (batch, side, side, 3) uint8 -> the same, normalized


def _tile_knobs(cfg: dict) -> dict:
    keys = {"macenko": ("luminosity_threshold", "angular_percentile",
                        "q_conc", "regularizer", "n_bisect", "fit_stride"),
            "vahadane": ("regularizer_fit", "regularizer", "num_iters",
                         "luminosity_threshold", "n_bisect", "q_conc",
                         "fit_stride")}[cfg["extractor"]]
    return {k: cfg[k] for k in keys}


def _fit_kwargs(cfg: dict) -> dict:
    """The drop-in ``fit``'s arguments: the lasso's regularizer and, for
    Macenko, the extractor's threshold and angular percentile (Vahadane's
    fit keeps its extractor's defaults: threshold 0.8, dictionary
    regularizer 0.1, 12 iterations)."""
    if cfg["extractor"] == "macenko":
        return dict(regularizer=cfg["regularizer"],
                    luminosity_threshold=cfg["luminosity_threshold"],
                    angular_percentile=cfg["angular_percentile"])
    return dict(regularizer=cfg["regularizer"])


def load(device) -> None:
    """Build (first run in a checkout) and load the kernel library."""
    if torch.device(device).type == "cuda":
        from stainlib_tpu_torch.kernels import _build

        _build.load_library()


def program(cfg: dict, traffic: dict, target, mosaic) -> Program:
    """The port, fitted and ready: its fits and its batched entry."""
    from stainlib_tpu_torch.kernels.macenko_fused import (
        macenko_normalize, normalize_with_matrix)
    from stainlib_tpu_torch.kernels.vahadane_fused import vahadane_normalize
    from stainlib_tpu_torch.normalization import extractive

    method = cfg["extractor"]
    p = extractive.fit(target, method=method, **_fit_kwargs(cfg))
    M_tgt = p.stain_matrix_target.to(torch.float32).contiguous()
    mc_tgt = p.max_c_target.to(torch.float32).contiguous()
    fits = {"target_M": M_tgt, "target_maxC": mc_tgt}
    if traffic["estimation"] == "slide":
        s = extractive.fit(mosaic, method=method, **_fit_kwargs(cfg))
        M_src = s.stain_matrix_target.to(torch.float32).contiguous()
        mc_src = s.max_c_target.to(torch.float32).contiguous()
        fits.update(slide_M=M_src, slide_maxC=mc_src)
        reg = cfg["regularizer"]
        return Program(fits, lambda b: normalize_with_matrix(
            b, M_src, mc_src, M_tgt, mc_tgt, reg))
    kern = macenko_normalize if method == "macenko" else vahadane_normalize
    knobs = _tile_knobs(cfg)
    return Program(fits, lambda b: kern(b, M_tgt, mc_tgt, **knobs))


def reference(cfg: dict, traffic: dict, target, mosaic,
              low=None) -> Program:
    """The plain reference in the program's place; ``low`` (a dtype) makes
    it the control (``reference/ops.lowp``)."""
    method = cfg["extractor"]
    M_tgt, mc_tgt = ref_ops.fit(target, method=method, low=low,
                                **_fit_kwargs(cfg))
    fits = {"target_M": M_tgt, "target_maxC": mc_tgt}
    if traffic["estimation"] == "slide":
        M_src, mc_src = ref_ops.fit(mosaic, method=method, low=low,
                                    **_fit_kwargs(cfg))
        fits.update(slide_M=M_src, slide_maxC=mc_src)
        reg = cfg["regularizer"]
        return Program(fits, lambda b: ref_planar.normalize_with_matrix(
            b, M_src, mc_src, M_tgt, mc_tgt, reg, low=low))
    kern = (ref_planar.macenko_normalize if method == "macenko"
            else ref_planar.vahadane_normalize)
    knobs = _tile_knobs(cfg)
    return Program(fits, lambda b: kern(b, M_tgt, mc_tgt, low=low, **knobs))


def tissue_share(cfg: dict, batch) -> float:
    """The share of the batch's pixels in the tissue mask (the roofline's
    operation count depends on it)."""
    lut = ref_planar._tables(batch.device)
    x = batch.reshape(-1, 3).to(torch.long)
    mask = (lut[1][x[:, 0]] + lut[2][x[:, 1]] + lut[3][x[:, 2]]
            < ref_planar._y_threshold(cfg["luminosity_threshold"]))
    return float(mask.to(torch.float32).mean())
