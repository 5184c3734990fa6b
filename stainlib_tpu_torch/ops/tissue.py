"""Tissue masking and luminosity/brightness standardization.

Port of the JAX package's ``ops/tissue.py:27-71``, the batched forms of the
reference's ``LuminosityThresholdTissueLocator.get_tissue_mask``
(``stainlib/utils/stain_utils.py:29-48``), ``LuminosityStandardizer.
standardize`` (``stain_utils.py:50-67``) and ``standardize_brightness``
(``stain_utils.py:188-194``). All functions broadcast over leading axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stainlib_tpu_torch.ops import colorspace
from stainlib_tpu_torch.ops.fdiv import fdiv
from stainlib_tpu_torch.ops.percentile import percentile


class TissueMask(NamedTuple):
    """Boolean mask plus per-image valid-pixel count; ``count == 0`` is
    the reference's ``TissueMaskException`` (``stain_utils.py:46-47``)."""

    mask: torch.Tensor  # (..., H, W) bool
    count: torch.Tensor  # (...,) int32


def tissue_mask(rgb, luminosity_threshold: float = 0.8) -> TissueMask:
    """Luminosity tissue mask over (..., H, W, 3) RGB in [0,255]."""
    L = fdiv(colorspace.lab_luminance(rgb), 100.0)
    mask = L < luminosity_threshold
    count = mask.sum((-2, -1)).to(torch.int32)
    return TissueMask(mask=mask, count=count)


def luminosity_standardize(rgb, saturation_percentile: float = 95.0):
    """Saturate the LAB L channel at a per-image percentile; RGB float
    [0,255] out: L' = clip(100 * L / p, 0, 100)."""
    lab = colorspace.rgb_to_lab(rgb)
    L = lab[..., 0]
    p = percentile(L, saturation_percentile, axis=(-2, -1))
    L = torch.clamp(100.0 * L / torch.clamp_min(p[..., None, None], 1e-6),
                    0.0, 100.0)
    lab = torch.stack([L, lab[..., 1], lab[..., 2]], dim=-1)
    return colorspace.lab_to_rgb(lab)


def standardize_brightness(rgb, q: float = 90.0):
    """Divide by the per-image q-th percentile of all channel values and
    clip; float output in [0,255]."""
    x = torch.as_tensor(rgb).to(torch.float32)
    p = percentile(x, q, axis=(-3, -2, -1))
    return torch.clamp(
        x * 255.0 / torch.clamp_min(p[..., None, None, None], 1e-6),
        0.0, 255.0)
