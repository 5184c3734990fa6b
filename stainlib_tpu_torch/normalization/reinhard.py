"""Reinhard LAB statistics transfer, batched.

Port of the JAX package's ``normalization/reinhard.py:24-118``, the batched
re-design of ``ReinhardStainNormalizer`` (``stainlib/normalization/
normalizer.py:54-94``, E. Reinhard et al., 'Color transfer between
images'): brightness standardization, per-channel LAB mean/std matching,
optional background masking that paints non-tissue white. ``quantize``
emulates the reference's uint8 OpenCV intermediates (``lab_split`` /
``merge_back`` / ``cv.meanStdDev``, ``stain_utils.py:146-186``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stainlib_tpu_torch.ops.colorspace import lab_to_rgb, rgb_to_lab, to_uint8
from stainlib_tpu_torch.ops.percentile import mean_std
from stainlib_tpu_torch.ops.tissue import standardize_brightness, tissue_mask

_PACK_SCALE = (2.55, 1.0, 1.0)  # uint8 LAB: (L*2.55, a+128, b+128)
_PACK_SHIFT = (0.0, 128.0, 128.0)


class ReinhardParams(NamedTuple):
    """Fitted target statistics (LAB units: L in [0,100], a/b centered)."""

    means: torch.Tensor  # (..., 3)
    stds: torch.Tensor  # (..., 3)


def _pack(device):
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return f32(_PACK_SCALE), f32(_PACK_SHIFT)


def _quantize_lab(lab):
    """Pass through the reference's uint8 LAB image: pack, round half to
    even (``cvRound``), clip to [0, 255], unpack (``reinhard.py:31-39``)."""
    scale, shift = _pack(lab.device)
    packed = torch.clamp(torch.round(lab * scale + shift), 0.0, 255.0)
    return (packed - shift) / scale


def _quantize_u8(x):
    """uint8 truncation after clipping, on a float image. The result is
    uint8, so :func:`rgb_to_lab` and :func:`tissue_mask` take their gamma
    curve from a 256-entry table."""
    return torch.floor(torch.clamp(x, 0.0, 255.0)).to(torch.uint8)


def fit(target_rgb, quantize: bool = True) -> ReinhardParams:
    """Fit to a target image or batch (``normalizer.py:64-68``): brightness
    standardize, then per-channel LAB mean and population std."""
    I = standardize_brightness(torch.as_tensor(target_rgb).to(torch.float32))
    if quantize:
        I = _quantize_u8(I)
    lab = rgb_to_lab(I)
    if quantize:
        lab = _quantize_lab(lab)
    means, stds = mean_std(lab, axis=(-3, -2))
    return ReinhardParams(means=means, stds=stds)


def transform(params: ReinhardParams, rgb, mask_background: bool = False,
              luminosity_threshold: float = 0.8, quantize: bool = True,
              source_stats: ReinhardParams | None = None,
              brightness_divisor=None):
    """Normalize a batch toward the fitted statistics
    (``normalizer.py:70-94``): (..., H, W, 3) RGB in, uint8 RGB out.

    ``mask_background`` paints non-tissue pixels white (L=100, a=b=0).
    ``source_stats`` / ``brightness_divisor`` replace the per-image source
    LAB statistics and 90th-percentile brightness divisor with fixed
    values (the estimation-hoisted variant of ``reinhard.py:78-82``).
    """
    I = torch.as_tensor(rgb).to(torch.float32)
    if brightness_divisor is None:
        I = standardize_brightness(I)
    else:
        div = torch.clamp_min(torch.as_tensor(
            brightness_divisor, dtype=torch.float32, device=I.device), 1e-6)
        I = torch.clamp(I * 255.0 / div, 0.0, 255.0)
    if quantize:
        I = _quantize_u8(I)
    lab = rgb_to_lab(I)
    if quantize:
        lab = _quantize_lab(lab)
    if source_stats is None:
        means, stds = mean_std(lab, axis=(-3, -2))
    else:
        means, stds = source_stats.means, source_stats.stds
    scale = params.stds / torch.clamp_min(stds, 1e-6)
    norm = (lab - means[..., None, None, :]) * scale[..., None, None, :]
    norm = norm + params.means[..., None, None, :]

    if mask_background:
        m = tissue_mask(I, luminosity_threshold).mask[..., None]
        background = torch.tensor([100.0, 0.0, 0.0], dtype=torch.float32,
                                  device=norm.device)
        norm = torch.where(m, norm, background)

    if quantize:
        # merge_back: clip and truncate in the packed LAB domain
        # (stain_utils.py:160-172), then the LAB->RGB conversion rounds.
        pscale, shift = _pack(norm.device)
        packed = torch.floor(torch.clamp(norm * pscale + shift, 0.0, 255.0))
        norm = (packed - shift) / pscale
        return torch.clamp(torch.round(lab_to_rgb(norm)), 0.0,
                           255.0).to(torch.uint8)
    return to_uint8(lab_to_rgb(norm))
