"""Drop-in object API mirroring the reference's public classes.

Port of the JAX package's ``api.py``. Every class keeps the name,
constructor, attributes and raise contract of the reference
(``stainlib/__init__.py:19-30``): single uint8 numpy images go in and come
out. Each call runs on an explicit ``device``, which defaults to
``"cuda"``; nothing falls back to the CPU by itself.

Class -> reference mapping:
  * ``LuminosityThresholdTissueLocator``  -> ``stain_utils.py:29-48``
  * ``LuminosityStandardizer``            -> ``stain_utils.py:50-67``
  * ``MacenkoStainExtractor``             -> ``macenko_stain_extractor.py:5-44``
  * ``VahadaneStainExtractor``            -> ``vahadane_stain_extractor.py:16-43``
  * ``ExtractiveStainNormalizer``         -> ``normalizer.py:16-50``
  * ``ReinhardStainNormalizer``           -> ``normalizer.py:54-94``
"""

from __future__ import annotations

import numpy as np
import torch

from stainlib_tpu_torch.exceptions import TissueMaskException
from stainlib_tpu_torch.extraction.macenko import stain_matrix_macenko
from stainlib_tpu_torch.extraction.vahadane import stain_matrix_vahadane
from stainlib_tpu_torch.kernels.macenko_fused import macenko_normalize
from stainlib_tpu_torch.kernels.reinhard_fused import reinhard_normalize
from stainlib_tpu_torch.kernels.vahadane_fused import vahadane_normalize
from stainlib_tpu_torch.normalization import extractive as _extractive
from stainlib_tpu_torch.normalization import reinhard as _reinhard
from stainlib_tpu_torch.ops import tissue as _tissue
from stainlib_tpu_torch.ops.colorspace import to_uint8
from stainlib_tpu_torch.ops.lasso import get_concentrations as _get_concentrations


def _device(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but PyTorch sees no CUDA device; pass "
            "device='cpu' to run on the CPU")
    return d


def _tensor(I, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(I)).to(_device(device))


def _check_uint8_image(I):
    if not (isinstance(I, np.ndarray) and I.ndim == 3 and I.dtype == np.uint8):
        raise AssertionError("Image should be RGB uint8.")


def _require_tissue(I, luminosity_threshold: float = 0.8, device="cuda"):
    """Raise like the reference's ``get_tissue_mask`` on an empty mask
    (``normalizer.py:45`` -> ``stain_utils.py:46-47``)."""
    count = _tissue.tissue_mask(_tensor(I, device), luminosity_threshold).count
    if int(count) == 0:
        raise TissueMaskException("Empty tissue mask computed")


def _use_fused(I, device) -> bool:
    """Single images go through the method's fused per-tile CUDA kernel on
    a CUDA device, with the JAX package's gate (``api.py:55-65``): lane-aligned
    and at most 512^2 pixels, where its estimation sample is defined. Other
    images, and every image on the CPU, take the functional path."""
    n_pixels = I.shape[0] * I.shape[1]
    return (torch.device(device).type == "cuda"
            and n_pixels % 128 == 0
            and n_pixels <= 512 * 512)


def _use_tiled(I, device) -> bool:
    """Images over 512^2 pixels on a CUDA device take the tiled route
    (``api.py:82-89``): one estimate on a grid subsample, then the
    fixed-matrix kernel on every pixel (``extractive.transform_tiled``).
    On the CPU they take the functional path."""
    return (torch.device(device).type == "cuda"
            and I.shape[0] * I.shape[1] > 512 * 512)


def _fast_fit_kwargs(I, method: str) -> dict:
    """Estimation-subsample knobs of the fused route, only at >= 256^2
    where their fidelity was validated (``api.py:68-79``); smaller tiles
    keep the full-resolution fit."""
    if I.shape[0] * I.shape[1] < 256 * 256:
        return {}
    return (dict(fit_stride=2, n_bisect=10) if method == "macenko"
            else dict(fit_stride=2, num_iters=8, n_bisect=10))


class LuminosityThresholdTissueLocator:
    """Boolean tissue mask by LAB-luminosity threshold."""

    @staticmethod
    def get_tissue_mask(I, luminosity_threshold: float = 0.8, device="cuda"):
        _check_uint8_image(I)
        tm = _tissue.tissue_mask(_tensor(I, device), luminosity_threshold)
        if int(tm.count) == 0:
            raise TissueMaskException("Empty tissue mask computed")
        return tm.mask.cpu().numpy()


class LuminosityStandardizer:
    """Percentile luminosity saturation (``stain_utils.py:50-67``)."""

    @staticmethod
    def standardize(I, percentile: float = 95, device="cuda"):
        _check_uint8_image(I)
        out = _tissue.luminosity_standardize(_tensor(I, device), percentile)
        return to_uint8(out).cpu().numpy()


class MacenkoStainExtractor:
    @staticmethod
    def get_stain_matrix(I, luminosity_threshold=0.8, angular_percentile=99,
                         device="cuda"):
        _check_uint8_image(I)
        M = stain_matrix_macenko(_tensor(I, device), luminosity_threshold,
                                 angular_percentile).cpu().numpy()
        if np.isnan(M).any():
            raise TissueMaskException("Empty tissue mask computed")
        return M


class VahadaneStainExtractor:
    @staticmethod
    def get_stain_matrix(I, luminosity_threshold=0.8, regularizer=0.1,
                         device="cuda"):
        _check_uint8_image(I)
        M = stain_matrix_vahadane(_tensor(I, device), luminosity_threshold,
                                  regularizer).cpu().numpy()
        if np.isnan(M).any():
            raise TissueMaskException("Empty tissue mask computed")
        return M


def get_concentrations(I, stain_matrix, regularizer: float = 0.01,
                       device="cuda"):
    """Per-pixel stain concentrations, flattened to (H*W, 2) like
    ``stain_utils.py:69-78``."""
    C = _get_concentrations(_tensor(I, device),
                            torch.as_tensor(np.asarray(stain_matrix)),
                            regularizer)
    return C.cpu().numpy().reshape(-1, 2)


class ExtractiveStainNormalizer:
    """fit/transform stain normalization (``normalizer.py:16-50``)."""

    def __init__(self, method: str, device="cuda"):
        method = method.lower()
        if method not in ("macenko", "vahadane"):
            raise Exception("Method not recognized.")
        self.method = _extractive.check_method(method)
        self.device = _device(device)
        self._params: _extractive.ExtractiveParams | None = None

    def fit(self, target):
        _check_uint8_image(target)
        self._params = _extractive.fit(_tensor(target, self.device),
                                       method=self.method)
        if bool(torch.isnan(self._params.stain_matrix_target).any()):
            raise TissueMaskException("Empty tissue mask computed")

    # Reference attribute names, for drop-in compatibility.
    @property
    def stain_matrix_target(self):
        return self._params.stain_matrix_target.cpu().numpy()

    @property
    def maxC_target(self):
        return self._params.max_c_target.cpu().numpy().reshape(1, 2)

    def transform(self, I):
        _check_uint8_image(I)
        if self._params is None:
            raise RuntimeError("Call fit(target) before transform().")
        # transform re-estimates the source stain matrix, which raises on
        # an empty tissue mask in the reference (normalizer.py:45).
        _require_tissue(I, device=self.device)
        x = _tensor(I, self.device)
        if _use_fused(I, self.device):
            fused = (macenko_normalize if self.method == "macenko"
                     else vahadane_normalize)
            out = fused(x[None], self._params.stain_matrix_target,
                        self._params.max_c_target,
                        **_fast_fit_kwargs(I, self.method))[0]
        elif _use_tiled(I, self.device):
            out = _extractive.transform_tiled(
                self._params, x, method=self.method,
                est_stride=_extractive.tiled_est_stride(*I.shape[:2]))
        else:
            out = _extractive.transform(self._params, x, method=self.method)
        return out.cpu().numpy()


class ReinhardStainNormalizer:
    """fit/transform Reinhard LAB transfer (``normalizer.py:54-94``)."""

    def __init__(self, target_means=0, target_stds=0, device="cuda"):
        self.target_means = target_means
        self.target_stds = target_stds
        self.device = _device(device)
        self._params: _reinhard.ReinhardParams | None = None

    def fit(self, target):
        _check_uint8_image(target)
        self._params = _reinhard.fit(_tensor(target, self.device))
        self.target_means = self._params.means.cpu().numpy()
        self.target_stds = self._params.stds.cpu().numpy()

    def transform(self, I, mask_background: bool = False,
                  luminosity_threshold: float = 0.8):
        _check_uint8_image(I)
        if self._params is None:
            raise RuntimeError("Call fit(target) before transform().")
        if mask_background:
            # The reference's background-masking branch calls
            # get_tissue_mask, which raises on an empty mask
            # (normalizer.py:85-90).
            _require_tissue(I, luminosity_threshold, device=self.device)
        x = _tensor(I, self.device)
        if not mask_background and _use_fused(I, self.device):
            out = reinhard_normalize(x[None], self._params.means,
                                     self._params.stds)[0]
        else:
            out = _reinhard.transform(
                self._params, x, mask_background=mask_background,
                luminosity_threshold=luminosity_threshold)
        return out.cpu().numpy()
