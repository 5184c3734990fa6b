"""Stain and color augmentation as batched torch functions.

Port of the JAX package's ``augmentation/functional.py``, the batched
re-design of ``stainlib/augmentation/augmenter.py`` and the DANN RGB jitter
(``dlmodels/stain_adversarial_learning/utils/utils_patches.py:33-50``).

Randomness: where the JAX functions take a ``jax.random`` key, these take a
``torch.Generator`` (None: torch's default CPU generator). The per-image
draws (a few floats per image) come from the generator on its own device,
then move to the images' device, so one CPU generator and seed give the
same draws on the CPU and on the card. ``jax.random`` bits cannot be
reproduced, so each public function is a draw followed by a private
``_..._apply`` that takes the draws; the tests feed both packages the same
draws through it.

All entry points take (..., H, W, 3) RGB in [0,255] and return uint8.
``stain_augment`` runs the fused kernels on a CUDA device: K6 (Macenko) or
K8 + K7 (Vahadane) for lane-aligned images up to 512^2, the functional
estimate and K7 over larger fields.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from stainlib_tpu_torch.extraction.macenko import stain_matrix_macenko
from stainlib_tpu_torch.extraction.vahadane import stain_matrix_vahadane
from stainlib_tpu_torch.kernels.fused_stain import (
    blockify,
    from_planar,
    to_planar,
    unblockify,
)
from stainlib_tpu_torch.kernels.macenko_fused import (
    augment_with_matrix,
    augment_with_matrix_planar,
    macenko_augment,
)
from stainlib_tpu_torch.kernels.vahadane_fused import (
    _prior_where_nan,
    vahadane_augment,
    vahadane_stain_matrix_planar,
)
from stainlib_tpu_torch.normalization.extractive import reconstruct
from stainlib_tpu_torch.ops.colorspace import (
    hed_to_rgb,
    rgb_to_gray,
    rgb_to_hed,
    to_uint8,
)
from stainlib_tpu_torch.ops.fdiv import fdiv
from stainlib_tpu_torch.ops.lasso import get_concentrations
from stainlib_tpu_torch.ops.tissue import tissue_mask

Range = Optional[Tuple[float, float]]


def _uniform_host(generator, shape, low, high):
    """Uniform float32 draws ``low + u * (high - low)`` of ``shape`` from
    ``generator``, on its own device. ``low``/``high``: numbers, or
    sequences over the last axis."""
    gdev = generator.device if generator is not None else torch.device("cpu")
    u = torch.rand(tuple(shape), generator=generator, device=gdev,
                   dtype=torch.float32)
    lo = torch.as_tensor(low, dtype=torch.float32, device=gdev)
    hi = torch.as_tensor(high, dtype=torch.float32, device=gdev)
    return lo + u * (hi - lo)


def _uniform(generator, shape, low, high, device):
    """:func:`_uniform_host`'s draws, moved to ``device``."""
    return _uniform_host(generator, shape, low, high).to(device)


def _range_draws(generator, lead, ranges: Sequence[Range], none_value: float,
                 device):
    """Per-image draws for three channel ranges; ``None`` -> ``none_value``
    (``functional.py:36-45``, ``HedColorAugmenter.randomize`` vectorized)."""
    lows = [r[0] if r is not None else none_value for r in ranges]
    highs = [r[1] if r is not None else none_value for r in ranges]
    return _uniform(generator, tuple(lead) + (3,), lows, highs, device)


def _image_mean(x):
    """Per-image mean over (H, W, 3), summed in float64 and rounded once."""
    n = x.shape[-3] * x.shape[-2] * x.shape[-1]
    return (x.double().sum((-3, -2, -1)) / n).to(torch.float32)


# --------------------------------------------------------------------------
# HED jitter (augmenter.py:86-344 + presets :346-372)
# --------------------------------------------------------------------------


def hed_jitter_apply(rgb, sigmas, biases, cutoff_range=(0.0, 1.0)):
    """Apply given per-image HED sigma/bias (``augmenter.py:276-326``).

    ``sigmas``/``biases``: (..., 3) per-image H/E/D parameters. Patches
    whose mean (RGB/255) falls outside ``cutoff_range`` pass through
    unchanged (``augmenter.py:287-293``)."""
    rgb = torch.as_tensor(rgb)
    x = rgb.to(torch.float32)
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32, device=x.device)
    biases = torch.as_tensor(biases, dtype=torch.float32, device=x.device)
    hed = rgb_to_hed(rgb)  # uint8 input: the logarithm is a table
    hed = hed * (1.0 + sigmas[..., None, None, :]) + biases[..., None, None, :]
    out = hed_to_rgb(hed)
    patch_mean = fdiv(_image_mean(x), 255.0)
    inside = (cutoff_range[0] <= patch_mean) & (patch_mean <= cutoff_range[1])
    return to_uint8(torch.where(inside[..., None, None, None], out, x))


def hed_jitter(
    rgb,
    generator: torch.Generator | None = None,
    haematoxylin_sigma_range: Range = (-0.1, 0.1),
    haematoxylin_bias_range: Range = (-0.1, 0.1),
    eosin_sigma_range: Range = (-0.1, 0.1),
    eosin_bias_range: Range = (-0.1, 0.1),
    dab_sigma_range: Range = (-0.1, 0.1),
    dab_bias_range: Range = (-0.1, 0.1),
    cutoff_range: Tuple[float, float] = (0.0, 1.0),
):
    """randomize() + transform() fused: fresh per-image draws from the
    ranges (sigmas first, then biases)."""
    rgb = torch.as_tensor(rgb)
    lead = rgb.shape[:-3]
    sigmas = _range_draws(
        generator, lead,
        [haematoxylin_sigma_range, eosin_sigma_range, dab_sigma_range], 0.0,
        rgb.device)
    biases = _range_draws(
        generator, lead,
        [haematoxylin_bias_range, eosin_bias_range, dab_bias_range], 0.0,
        rgb.device)
    return hed_jitter_apply(rgb, sigmas, biases, cutoff_range)


def hed_preset(thresh: float):
    """Symmetric preset of ``HedColorAugmenter1`` (``augmenter.py:346-360``):
    all six ranges (-thresh, thresh), cutoff (0.05, 0.95)."""
    r = (-thresh, thresh)
    return dict(
        haematoxylin_sigma_range=r,
        haematoxylin_bias_range=r,
        eosin_sigma_range=r,
        eosin_bias_range=r,
        dab_sigma_range=r,
        dab_bias_range=r,
        cutoff_range=(0.05, 0.95),
    )


def hed_lighter(rgb, generator=None):
    """``HedLighterColorAugmenter`` preset, thresh=0.03 (``augmenter.py:362``)."""
    return hed_jitter(rgb, generator, **hed_preset(0.03))


def hed_light(rgb, generator=None):
    """``HedLightColorAugmenter`` preset, thresh=0.1 (``augmenter.py:366``)."""
    return hed_jitter(rgb, generator, **hed_preset(0.1))


def hed_strong(rgb, generator=None):
    """``HedStrongColorAugmenter`` preset, thresh=1.0 (``augmenter.py:370``)."""
    return hed_jitter(rgb, generator, **hed_preset(1.0))


# --------------------------------------------------------------------------
# Grayscale (augmenter.py:374-401)
# --------------------------------------------------------------------------


def _grayscale_apply(rgb, alpha, beta):
    """Per-image ``clip(gray * alpha + beta, 0, 1)`` on skimage-luma
    grayscale, stacked back to three channels."""
    g = rgb_to_gray(rgb)
    g = torch.clamp(g * alpha[..., None, None] + beta[..., None, None],
                    0.0, 1.0)
    return to_uint8(torch.stack([g, g, g], dim=-1) * 255.0)


def grayscale_augment(rgb, generator=None):
    """Per-image alpha~U(0.8,1.2), beta~U(-0.2,0.2) on skimage-luma
    grayscale (``GrayscaleAugmentor.pop``, ``augmenter.py:390-401``; the
    reference hard-codes 0.2 whatever its sigma constructor arguments)."""
    rgb = torch.as_tensor(rgb)
    lead = rgb.shape[:-3]
    alpha = _uniform(generator, lead, 0.8, 1.2, rgb.device)
    beta = _uniform(generator, lead, -0.2, 0.2, rgb.device)
    return _grayscale_apply(rgb, alpha, beta)


# --------------------------------------------------------------------------
# Stain-concentration perturbation (augmenter.py:403-448)
# --------------------------------------------------------------------------

_EXTRACTORS = {"macenko": stain_matrix_macenko, "vahadane": stain_matrix_vahadane}


class StainAugmentParams(NamedTuple):
    """``StainAugmentor.fit`` state (``augmenter.py:416-426``)."""

    stain_matrix: torch.Tensor  # (..., 2, 3)
    concentrations: torch.Tensor  # (..., H, W, 2)
    mask: torch.Tensor  # (..., H, W) bool


def stain_augment_fit(rgb, method: str = "macenko", **extractor_kwargs):
    """Fit on (..., H, W, 3) RGB: stain matrix, concentrations, tissue mask."""
    rgb = torch.as_tensor(rgb)
    M = _EXTRACTORS[method.lower()](rgb, **extractor_kwargs)
    C = get_concentrations(rgb, M)
    mask = tissue_mask(rgb).mask
    return StainAugmentParams(stain_matrix=M, concentrations=C, mask=mask)


def _stain_draws(generator, lead, sigma1, sigma2, device):
    """Per-image per-stain alpha~U(1-sigma1, 1+sigma1), then
    beta~U(-sigma2, sigma2), each (*lead, 2)."""
    shape = tuple(lead) + (2,)
    alpha = _uniform_host(generator, shape, 1.0 - sigma1, 1.0 + sigma1)
    beta = _uniform_host(generator, shape, -sigma2, sigma2)
    # One copy to the images' device for both.
    both = torch.stack([alpha, beta]).to(device)
    return both[0], both[1]


def _stain_augment_pop_apply(params: StainAugmentParams, alpha, beta,
                             augment_background: bool = False):
    """``C * alpha + beta`` on the fitted concentrations (tissue only
    unless ``augment_background``), reconstructed through the fitted
    matrix."""
    C = params.concentrations
    C_aug = C * alpha[..., None, None, :] + beta[..., None, None, :]
    if not augment_background:
        C_aug = torch.where(params.mask[..., None], C_aug, C)
    return reconstruct(C_aug, params.stain_matrix[..., None, None, :, :])


def stain_augment_pop(params: StainAugmentParams, generator=None,
                      sigma1: float = 0.2, sigma2: float = 0.2,
                      augment_background: bool = False):
    """One augmented draw (``StainAugmentor.pop``, ``augmenter.py:428-448``):
    per-stain alpha~U(1-sigma1,1+sigma1), beta~U(-sigma2,sigma2) applied to
    the fitted concentrations (tissue-only unless ``augment_background``)."""
    alpha, beta = _stain_draws(generator, params.stain_matrix.shape[:-2],
                               sigma1, sigma2, params.concentrations.device)
    return _stain_augment_pop_apply(params, alpha, beta, augment_background)


class FusedStainAugmentState(NamedTuple):
    """Fit-once/pop-many state of the fused route: the planar uint8 tiles
    and their per-tile 2x3 stain matrices. The estimate runs once at fit;
    every pop is one pass of the augment-apply kernel K7 on a CUDA device
    (``functional.py:185-196``)."""

    planar: torch.Tensor  # (B, 3, R, 128) uint8
    stain_matrix: torch.Tensor  # (B, 2, 3)
    h: int
    w: int


def stain_augment_fit_fused(rgb, method: str = "macenko",
                            luminosity_threshold: float = 0.8
                            ) -> FusedStainAugmentState:
    """Fused fit on (B, H, W, 3) lane-aligned tiles (H*W % 128 == 0):
    per-tile stain matrices from the dictionary kernel K8 with the prior
    where NaN (Vahadane) or from the functional extractor (Macenko), and
    the tiles kept in planar layout."""
    rgb = torch.as_tensor(rgb)
    if rgb.dtype != torch.uint8:
        rgb = to_uint8(rgb)
    _, H, W, _ = rgb.shape
    planar = to_planar(rgb).contiguous()
    if method.lower() == "vahadane":
        M = _prior_where_nan(vahadane_stain_matrix_planar(
            planar, luminosity_threshold=luminosity_threshold))
    else:
        M = _EXTRACTORS[method.lower()](
            rgb, luminosity_threshold=luminosity_threshold)
    return FusedStainAugmentState(planar=planar, stain_matrix=M, h=H, w=W)


def _stain_augment_pop_fused_apply(state: FusedStainAugmentState, alpha,
                                   beta, augment_background: bool = False):
    out = augment_with_matrix_planar(state.planar, state.stain_matrix,
                                     alpha, beta,
                                     augment_background=augment_background)
    return from_planar(out, state.h, state.w)


def stain_augment_pop_fused(state: FusedStainAugmentState, generator=None,
                            sigma1: float = 0.2, sigma2: float = 0.2,
                            augment_background: bool = False):
    """One augmented draw from the fused fit state: one K7 pass (lasso,
    tissue-gated ``C*alpha+beta``, reconstruction through the cached
    matrix). Same per-image draws as :func:`stain_augment_pop`."""
    alpha, beta = _stain_draws(generator, state.planar.shape[:1], sigma1,
                               sigma2, state.planar.device)
    return _stain_augment_pop_fused_apply(state, alpha, beta,
                                          augment_background)


def _augment_field(batch, alpha, beta, method: str,
                   augment_background: bool = False,
                   block: int | None = None):
    """The >512^2 route (``functional.py:284-321``): the functional
    extractor once per field (the prior where NaN), then K7 on every
    pixel. ``block=None`` runs K7 over the whole interleaved field in one
    launch; an int cuts white-padded ``block``-square tiles first, as the
    JAX route does, with identical bytes (the apply is per pixel)."""
    B, H, W, _ = batch.shape
    M = _prior_where_nan(_EXTRACTORS[method](batch))
    if block is None:
        return augment_with_matrix(batch, M, alpha, beta,
                                   augment_background=augment_background)
    blocks, grid = blockify(batch, block)
    per_img = grid[0] * grid[1]
    out = augment_with_matrix_planar(
        to_planar(blocks).contiguous(),
        M.reshape(B, 6).repeat_interleave(per_img, dim=0),
        alpha.repeat_interleave(per_img, dim=0),
        beta.repeat_interleave(per_img, dim=0),
        augment_background=augment_background)
    return unblockify(from_planar(out, block, block), grid, H, W)


def _stain_augment_apply(rgb, alpha, beta, method: str = "macenko",
                         augment_background: bool = False):
    """:func:`stain_augment` given its draws, (*lead, 2) each."""
    method = method.lower()
    lead = rgb.shape[:-3]
    n_pixels = rgb.shape[-3] * rgb.shape[-2]
    if (method in _EXTRACTORS and len(lead) <= 1
            and rgb.device.type == "cuda"
            and (n_pixels > 512 * 512 or n_pixels % 128 == 0)):
        batch = rgb if lead else rgb[None]
        if batch.dtype != torch.uint8:
            batch = to_uint8(batch)
        batch = batch.contiguous()
        a, b = alpha.reshape(-1, 2), beta.reshape(-1, 2)
        if n_pixels > 512 * 512:
            out = _augment_field(batch, a, b, method, augment_background)
        else:
            fused = macenko_augment if method == "macenko" else vahadane_augment
            out = fused(batch, a, b, augment_background=augment_background)
        return out if lead else out[0]
    params = stain_augment_fit(rgb, method)
    return _stain_augment_pop_apply(params, alpha, beta, augment_background)


def stain_augment(rgb, generator=None, method: str = "macenko",
                  sigma1: float = 0.2, sigma2: float = 0.2,
                  augment_background: bool = False):
    """Fit + one pop in a single call, for in-loop training augmentation.

    On a CUDA device, (H, W, 3) or (B, H, W, 3) Macenko/Vahadane input
    takes the fused kernels: lane-aligned images up to 512^2 through K6
    (Macenko) or K8 + K7 (Vahadane), larger fields through the functional
    estimate and K7. Everything else, and every CPU input, takes
    :func:`stain_augment_fit` + :func:`stain_augment_pop`. The draws are
    the same on every route; the pixels are not bitwise equal across
    routes (the fused estimate's bisection percentiles differ from the
    functional path by up to ~4 uint8 steps on ~1% of pixels,
    ``functional.py:255-259``)."""
    rgb = torch.as_tensor(rgb)
    alpha, beta = _stain_draws(generator, rgb.shape[:-3], sigma1, sigma2,
                               rgb.device)
    return _stain_augment_apply(rgb, alpha, beta, method, augment_background)


# --------------------------------------------------------------------------
# RGB jitter (DANN pipeline, utils_patches.py:33-50)
# --------------------------------------------------------------------------


def _rgb_jitter_apply(rgb, a, b):
    """``x * a + b`` per channel, then the per-image min/max rescale to
    [0,255] (``scale_range``, ``utils_patches.py:307-311``)."""
    x = torch.as_tensor(rgb).to(torch.float32)
    y = x * a[..., None, None, :] + b[..., None, None, :]
    y = y - torch.amin(y, dim=(-3, -2, -1), keepdim=True)
    y_max = torch.amax(y, dim=(-3, -2, -1), keepdim=True)
    y = y / (fdiv(y_max, 255.0 + 1e-5) + 1e-12)
    return to_uint8(y)


def rgb_jitter(rgb, generator=None):
    """Per-channel a~U(0.9,1.1), b~U(-10,10) on the uint8 scale, then a
    per-image min/max rescale to [0,255] (``color_augment_patches`` +
    ``scale_range``, ``utils_patches.py:33-50,307-311``). Returns uint8."""
    rgb = torch.as_tensor(rgb)
    shape = tuple(rgb.shape[:-3]) + (3,)
    a = _uniform(generator, shape, 0.9, 1.1, rgb.device)
    b = _uniform(generator, shape, -10.0, 10.0, rgb.device)
    return _rgb_jitter_apply(rgb, a, b)
