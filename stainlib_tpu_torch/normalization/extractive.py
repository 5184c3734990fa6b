"""Extractive (Macenko / Vahadane) stain normalization, batched end to end.

Port of the JAX package's ``normalization/extractive.py:29-115,202-206``,
the batched re-design of ``ExtractiveStainNormalizer``
(``stainlib/normalization/normalizer.py:16-50``): fit stores the target
stain matrix and the 99th-percentile concentration per stain; transform
re-estimates the source stain matrix per image, solves the exact lasso,
rescales by maxC_target / maxC_source and reconstructs
``255 * exp(-C @ M_target)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stainlib_tpu_torch.extraction.macenko import stain_matrix_macenko
from stainlib_tpu_torch.extraction.vahadane import stain_matrix_vahadane
from stainlib_tpu_torch.ops.colorspace import to_uint8
from stainlib_tpu_torch.ops.lasso import get_concentrations
from stainlib_tpu_torch.ops.percentile import percentile

_EXTRACTORS = {
    "macenko": stain_matrix_macenko,
    "vahadane": stain_matrix_vahadane,
}


class ExtractiveParams(NamedTuple):
    """Fitted target state (``normalizer.py:27-37``)."""

    stain_matrix_target: torch.Tensor  # (..., 2, 3)
    max_c_target: torch.Tensor  # (..., 2) 99th-pct concentration per stain


def check_method(method: str) -> str:
    """Lower-cased method name; raises ``KeyError`` for unknown methods."""
    method = method.lower()
    if method not in _EXTRACTORS:
        raise KeyError(method)
    return method


def fit(target_rgb, method: str = "macenko", regularizer: float = 0.01,
        **extractor_kwargs) -> ExtractiveParams:
    """Fit to a target image (..., H, W, 3); ``normalizer.py:27-37``."""
    M = _EXTRACTORS[check_method(method)](target_rgb, **extractor_kwargs)
    C = get_concentrations(target_rgb, M, regularizer)
    C = C.reshape(C.shape[:-3] + (-1, 2))
    max_c = percentile(C, 99.0, axis=-2)
    return ExtractiveParams(stain_matrix_target=M, max_c_target=max_c)


def transform(params: ExtractiveParams, rgb, method: str = "macenko",
              regularizer: float = 0.01, **extractor_kwargs):
    """Normalize a tile batch toward the fitted target
    (``normalizer.py:39-50``): (..., H, W, 3) RGB in [0,255] -> uint8."""
    M_src, max_c_src = estimate_source(rgb, method, regularizer,
                                       **extractor_kwargs)
    return transform_with_matrix(rgb, M_src, max_c_src, params, regularizer)


def transform_with_matrix(rgb, stain_matrix_src, max_c_src,
                          params: ExtractiveParams,
                          regularizer: float = 0.01):
    """Normalize with a fixed source stain matrix and maxC instead of
    re-estimating per image (``normalizer.py:46-50`` with the estimation
    hoisted out). (..., H, W, 3) RGB in [0,255] -> uint8."""
    C = get_concentrations(rgb, stain_matrix_src, regularizer)
    max_c_src = torch.as_tensor(max_c_src, device=C.device).to(torch.float32)
    scale = params.max_c_target / torch.clamp_min(max_c_src, 1e-8)
    C = C * scale[..., None, None, :]
    od = torch.einsum("...hwk,...kc->...hwc", C, params.stain_matrix_target)
    return to_uint8(255.0 * torch.exp(-od))


def estimate_source(rgb, method: str = "macenko", regularizer: float = 0.01,
                    **extractor_kwargs):
    """Per-image source estimation, (stain matrix, 99th-pct maxC) — the
    half of ``transform`` at ``normalizer.py:45-48`` with nothing applied."""
    M_src = _EXTRACTORS[check_method(method)](rgb, **extractor_kwargs)
    C = get_concentrations(rgb, M_src, regularizer)
    max_c_src = percentile(C.reshape(C.shape[:-3] + (-1, 2)), 99.0, axis=-2)
    return M_src, max_c_src


def reconstruct(concentrations, stain_matrix):
    """``255 * exp(-C @ M)`` -> uint8 (``normalizer.py:49-50``)."""
    od = torch.einsum("...k,...kc->...c", concentrations, stain_matrix)
    return to_uint8(255.0 * torch.exp(-od))
