"""Extractive (Macenko / Vahadane) stain normalization, batched end to end.

Port of the JAX package's ``normalization/extractive.py:29-206``,
the batched re-design of ``ExtractiveStainNormalizer``
(``stainlib/normalization/normalizer.py:16-50``): fit stores the target
stain matrix and the 99th-percentile concentration per stain; transform
re-estimates the source stain matrix per image, solves the exact lasso,
rescales by maxC_target / maxC_source and reconstructs
``255 * exp(-C @ M_target)``. ``transform_tiled`` is the route for large
fields: one estimate per image (kernel K4 or the functional path), then
the fixed-matrix kernel K3 on every pixel.
"""

from __future__ import annotations

from typing import NamedTuple

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
    macenko_fit_planar,
    normalize_with_matrix,
    normalize_with_matrix_planar,
)
from stainlib_tpu_torch.ops.colorspace import to_uint8
from stainlib_tpu_torch.ops.fdiv import f64
from stainlib_tpu_torch.ops.lasso import get_concentrations
from stainlib_tpu_torch.ops.percentile import percentile
from stainlib_tpu_torch.utils.profiling import annotate

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
    """Fit to a target image (..., H, W, 3); ``normalizer.py:27-37``.
    Traced (``utils.profiling.annotate``) as ``stain.fit`` around
    ``stain.fit.matrix``, ``stain.fit.concentrations`` and
    ``stain.fit.max_c``."""
    with annotate("stain.fit"):
        with annotate("stain.fit.matrix"):
            M = _EXTRACTORS[check_method(method)](target_rgb,
                                                  **extractor_kwargs)
        with annotate("stain.fit.concentrations"):
            C = get_concentrations(target_rgb, M, regularizer)
            C = C.reshape(C.shape[:-3] + (-1, 2))
        with annotate("stain.fit.max_c"):
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
    return reconstruct(C, params.stain_matrix_target[..., None, None, :, :])


def estimate_source(rgb, method: str = "macenko", regularizer: float = 0.01,
                    **extractor_kwargs):
    """Per-image source estimation, (stain matrix, 99th-pct maxC) — the
    half of ``transform`` at ``normalizer.py:45-48`` with nothing applied."""
    M_src = _EXTRACTORS[check_method(method)](rgb, **extractor_kwargs)
    C = get_concentrations(rgb, M_src, regularizer)
    max_c_src = percentile(C.reshape(C.shape[:-3] + (-1, 2)), 99.0, axis=-2)
    return M_src, max_c_src


def transform_tiled(params: ExtractiveParams, rgb, method: str = "macenko",
                    regularizer: float = 0.01, block: int | None = None,
                    est_stride: int = 1, fused_fit: bool = True,
                    **extractor_kwargs):
    """:func:`transform` for fields larger than the fused per-tile kernels
    take (``extractive.py:118-189``): estimate once per image, then apply
    the fixed-matrix kernel K3 (``macenko_fused.normalize_with_matrix``).

    ``est_stride`` > 1 estimates on the ``[::s, ::s]`` grid subsample of
    the field. The Macenko estimate takes the fit kernel K4 when the
    subsample, flattened and trimmed to whole 1024-pixel groups, keeps
    8192..512^2 pixels (``fused_fit``, no ``extractor_kwargs``); otherwise
    it takes the functional :func:`estimate_source` (always, for
    Vahadane). The apply is per pixel: with ``block=None`` K3 reads the
    whole field in one launch; an int cuts the field into white-padded
    ``block``-square tiles first, as the JAX route does, with identical
    bytes.

    ``rgb``: (B, H, W, 3) or (H, W, 3) uint8; any H, W.
    """
    single = rgb.ndim == 3
    if single:
        rgb = rgb[None]
    B, H, W, _ = rgb.shape

    est_in = (rgb if est_stride <= 1
              else rgb[:, ::est_stride, ::est_stride, :])
    npix = est_in.shape[1] * est_in.shape[2]
    n_keep = npix // 1024 * 1024
    if (fused_fit and check_method(method) == "macenko"
            and not extractor_kwargs and 8 * 1024 <= n_keep
            and npix <= 512 * 512):
        flat = est_in.reshape(B, npix, 3)[:, :n_keep]
        planar = flat.permute(0, 2, 1).reshape(
            B, 3, n_keep // 128, 128).contiguous()
        M_src, max_c_src = macenko_fit_planar(planar,
                                              regularizer=regularizer)
    else:
        M_src, max_c_src = estimate_source(est_in, method=method,
                                           regularizer=regularizer,
                                           **extractor_kwargs)
    args = (M_src, max_c_src, params.stain_matrix_target,
            params.max_c_target, regularizer)
    if block is None:
        out = normalize_with_matrix(rgb.contiguous(), *args)
    else:
        blocks, grid = blockify(rgb, block)
        per_img = grid[0] * grid[1]
        M_rep = M_src.reshape(B, 6).repeat_interleave(per_img, dim=0)
        mc_rep = max_c_src.reshape(B, 2).repeat_interleave(per_img, dim=0)
        out = normalize_with_matrix_planar(
            to_planar(blocks).contiguous(), M_rep, mc_rep, *args[2:])
        out = unblockify(from_planar(out, block, block), grid, H, W)
    return out[0] if single else out


def tiled_est_stride(h: int, w: int, floor: int = 256 * 256) -> int:
    """Largest power-of-two grid stride that keeps >= ``floor`` pixels in
    the estimation subsample (``extractive.py:192-199``)."""
    s = 1
    while (h // (2 * s)) * (w // (2 * s)) >= floor:
        s *= 2
    return s


def reconstruct(concentrations, stain_matrix):
    """``255 * exp(-C @ M)`` -> uint8 (``normalizer.py:49-50``), shared with
    the stain augmenter (``augmenter.py:445-448``). ``C @ M`` is written as
    ``C0 * M[0] + C1 * M[1]``, each product and the sum rounded in float32,
    and ``exp`` is evaluated in float64 and rounded once to float32, so the
    card and the CPU round both the same (a matrix product and a float32
    ``exp`` do not)."""
    C = torch.as_tensor(concentrations)
    M = torch.as_tensor(stain_matrix, device=C.device).to(C.dtype)
    od = C[..., 0:1] * M[..., 0, :] + C[..., 1:2] * M[..., 1, :]
    return to_uint8(255.0 * f64(torch.exp, -od))
