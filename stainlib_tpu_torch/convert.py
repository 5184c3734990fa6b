"""Carry fitted state from the JAX package into the port.

The counterparts of the JAX package's fitted state: ``ExtractiveParams``
(``normalization/extractive.py:35-39``, ``normalizer.py:27-37``),
``ReinhardParams`` (``normalization/reinhard.py:24-28``,
``normalizer.py:64-68``), and the stain augmenter's ``StainAugmentParams``
and ``FusedStainAugmentState`` (``augmentation/functional.py:149-196``),
and the slide-level estimates ``SlideStainParams`` and
``SlideReinhardParams`` (``normalization/slide.py:62-74``). Given the JAX fit as numpy arrays, build the port's, so both packages can
transform or pop from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from stainlib_tpu_torch.augmentation.functional import (
    FusedStainAugmentState,
    StainAugmentParams,
)
from stainlib_tpu_torch.normalization.extractive import ExtractiveParams
from stainlib_tpu_torch.normalization.reinhard import ReinhardParams
from stainlib_tpu_torch.normalization.slide import (
    SlideReinhardParams,
    SlideStainParams,
)


def _to(x, device):
    return torch.tensor(np.array(x, np.float32), device=device)


def params_from_jax(stain_matrix_target, max_c_target, device) -> ExtractiveParams:
    """``np.asarray`` of a JAX ``ExtractiveParams``' fields -> the port's
    ``ExtractiveParams`` on ``device``, float32."""
    return ExtractiveParams(stain_matrix_target=_to(stain_matrix_target, device),
                            max_c_target=_to(max_c_target, device))


def reinhard_params_from_jax(means, stds, device) -> ReinhardParams:
    """``np.asarray`` of a JAX ``ReinhardParams``' ``means`` and ``stds`` ->
    the port's ``ReinhardParams`` on ``device``, float32."""
    return ReinhardParams(means=_to(means, device), stds=_to(stds, device))


def stain_augment_params_from_jax(stain_matrix, concentrations, mask,
                                  device) -> StainAugmentParams:
    """``np.asarray`` of a JAX ``StainAugmentParams``' fields -> the port's
    ``StainAugmentParams`` on ``device``: float32 matrix and
    concentrations, boolean mask."""
    return StainAugmentParams(
        stain_matrix=_to(stain_matrix, device),
        concentrations=_to(concentrations, device),
        mask=torch.tensor(np.array(mask, bool), device=device))


def fused_augment_state_from_jax(planar, stain_matrix, h: int, w: int,
                                 device) -> FusedStainAugmentState:
    """``np.asarray`` of a JAX ``FusedStainAugmentState``' planar uint8
    tiles and stain matrices, with its ``h`` and ``w`` -> the port's
    ``FusedStainAugmentState`` on ``device``."""
    return FusedStainAugmentState(
        planar=torch.tensor(np.array(planar, np.uint8), device=device),
        stain_matrix=_to(stain_matrix, device), h=int(h), w=int(w))


def slide_params_from_jax(p, device) -> SlideStainParams:
    """A JAX ``SlideStainParams`` (numpy fields) -> the port's, float32 on
    ``device``."""
    return SlideStainParams(stain_matrix=_to(p.stain_matrix, device),
                            max_c=_to(p.max_c, device))


def slide_reinhard_params_from_jax(p, device) -> SlideReinhardParams:
    """A JAX ``SlideReinhardParams`` (numpy LAB stats, a float divisor) ->
    the port's, its stats float32 on ``device``."""
    return SlideReinhardParams(
        stats=reinhard_params_from_jax(np.asarray(p.stats.means),
                                       np.asarray(p.stats.stds), device),
        brightness_divisor=float(p.brightness_divisor))
