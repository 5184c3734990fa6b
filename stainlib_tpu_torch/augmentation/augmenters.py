"""Drop-in augmenter classes mirroring ``stainlib/augmentation/augmenter.py``.

Port of the JAX package's ``augmentation/augmenters.py``: the same names,
constructor signatures (``seed`` kept, ``device`` added, default
``"cuda"``), validation errors and ``randomize()/transform()`` or
``fit()/pop()`` contracts as the reference (``augmenter.py:19-448``).
Each object owns a CPU ``torch.Generator`` seeded from ``seed``: no global
random state. Execution is delegated to
:mod:`stainlib_tpu_torch.augmentation.functional`; on a CUDA device
``StainAugmentor.pop`` is one pass of the augment-apply kernel K7.
"""

from __future__ import annotations

import numpy as np
import torch

from stainlib_tpu_torch.api import _device, _tensor
from stainlib_tpu_torch.augmentation import functional as F
from stainlib_tpu_torch.exceptions import InvalidRangeError, TissueMaskException
from stainlib_tpu_torch.kernels.fused_stain import to_planar
from stainlib_tpu_torch.ops.colorspace import to_uint8
from stainlib_tpu_torch.ops.tissue import tissue_mask


def _validate_range(title, rng, lo=-1.0, hi=1.0):
    """Range validation of ``augmenter.py:160-274``."""
    if rng is None:
        return
    if len(rng) != 2 or rng[1] < rng[0] or rng[0] < lo or hi < rng[1]:
        raise InvalidRangeError(title, rng)


class AugmenterBase:
    """Base class for patch augmentation (``augmenter.py:19-70``)."""

    def __init__(self, keyword: str, seed: int = 0, device="cuda"):
        self._keyword = keyword
        self._generator = torch.Generator().manual_seed(seed)
        self.device = _device(device)

    @property
    def keyword(self):
        return self._keyword

    def shapes(self, target_shapes):
        """Output shapes match input shapes by default (``augmenter.py:44-57``)."""
        return target_shapes

    def transform(self, patch):
        raise NotImplementedError

    def randomize(self):
        pass


class ColorAugmenterBase(AugmenterBase):
    """Base class for color patch augmentation (``augmenter.py:72-84``)."""


class HedColorAugmenter(ColorAugmenterBase):
    """HED sigma/bias jitter (``augmenter.py:86-344``).

    ``randomize()`` draws fresh sigmas/biases; ``transform(patch)`` applies
    the current ones with the patch-mean cutoff gate. Accepts single HWC
    patches (uint8 or float [0,1], like the reference) or batches.
    """

    def __init__(self, haematoxylin_sigma_range, haematoxylin_bias_range,
                 eosin_sigma_range, eosin_bias_range, dab_sigma_range,
                 dab_bias_range, cutoff_range, seed: int = 0, device="cuda"):
        super().__init__(keyword="hed_color", seed=seed, device=device)
        for title, rng in [
            ("Haematoxylin Sigma", haematoxylin_sigma_range),
            ("Eosin Sigma", eosin_sigma_range),
            ("Dab Sigma", dab_sigma_range),
            ("Haematoxylin Bias", haematoxylin_bias_range),
            ("Eosin Bias", eosin_bias_range),
            ("Dab Bias", dab_bias_range),
        ]:
            _validate_range(title, rng)
        _validate_range("Cutoff", cutoff_range, lo=0.0, hi=1.0)

        self._sigma_ranges = [haematoxylin_sigma_range, eosin_sigma_range,
                              dab_sigma_range]
        self._bias_ranges = [haematoxylin_bias_range, eosin_bias_range,
                             dab_bias_range]
        self._cutoff_range = cutoff_range if cutoff_range is not None else (0.0, 1.0)
        # Initial parameters: range lower bounds (augmenter.py:196-201,255-259).
        self._sigmas = [r[0] if r is not None else 0.0 for r in self._sigma_ranges]
        self._biases = [r[0] if r is not None else 0.0 for r in self._bias_ranges]

    def randomize(self):
        u_s = torch.rand(3, generator=self._generator).tolist()
        u_b = torch.rand(3, generator=self._generator).tolist()
        # A None sigma range randomizes to 1.0 (not 0.0) in the reference
        # (augmenter.py:338-340); None bias randomizes to 0.0.
        self._sigmas = [r[0] + u * (r[1] - r[0]) if r is not None else 1.0
                        for r, u in zip(self._sigma_ranges, u_s)]
        self._biases = [r[0] + u * (r[1] - r[0]) if r is not None else 0.0
                        for r, u in zip(self._bias_ranges, u_b)]

    def transform(self, patch):
        patch = np.asarray(patch)
        is_float = patch.dtype.kind == "f"
        x = _tensor(patch * 255.0 if is_float else patch, self.device)
        lead = x.shape[:-3]

        def per_image(v):
            return torch.tensor(v, dtype=torch.float32,
                                device=self.device).expand(lead + (3,))

        out = F.hed_jitter_apply(x, per_image(self._sigmas),
                                 per_image(self._biases),
                                 tuple(self._cutoff_range)).cpu().numpy()
        return out.astype(np.float64) / 255.0 if is_float else out


class HedColorAugmenter1(HedColorAugmenter):
    """Symmetric-threshold preset (``augmenter.py:346-360``)."""

    def __init__(self, thresh, seed: int = 0, device="cuda"):
        r = (-thresh, thresh)
        super().__init__(r, r, r, r, r, r, cutoff_range=(0.05, 0.95),
                         seed=seed, device=device)


class HedLighterColorAugmenter(HedColorAugmenter1):
    def __init__(self, seed: int = 0, device="cuda"):
        super().__init__(0.03, seed=seed, device=device)


class HedLightColorAugmenter(HedColorAugmenter1):
    def __init__(self, seed: int = 0, device="cuda"):
        super().__init__(0.1, seed=seed, device=device)


class HedStrongColorAugmenter(HedColorAugmenter1):
    def __init__(self, seed: int = 0, device="cuda"):
        super().__init__(1.0, seed=seed, device=device)


class GrayscaleAugmentor:
    """fit/pop grayscale jitter (``augmenter.py:374-401``)."""

    def __init__(self, sigma1=0.2, sigma2=0.2, augment_background=False,
                 seed: int = 0, device="cuda"):
        self.sigma1 = sigma1
        self.sigma2 = sigma2
        self.augment_background = augment_background
        self.device = _device(device)
        self._generator = torch.Generator().manual_seed(seed)
        self.image = None

    def fit(self, I):
        self.image_shape = I.shape
        x = _tensor(I, self.device)
        tm = tissue_mask(x)
        if int(tm.count) == 0:
            raise TissueMaskException("Empty tissue mask computed")
        self.tissue_mask = tm.mask.cpu().numpy().ravel()
        self.image = x

    def pop(self):
        return F.grayscale_augment(self.image, self._generator).cpu().numpy()


class StainAugmentor:
    """fit/pop stain-concentration perturbation (``augmenter.py:403-448``)."""

    def __init__(self, method, sigma1=0.2, sigma2=0.2,
                 augment_background=False, seed: int = 0, device="cuda"):
        if method.lower() not in ("macenko", "vahadane"):
            raise Exception("Method not recognized.")
        self.method = method.lower()
        self.sigma1 = sigma1
        self.sigma2 = sigma2
        self.augment_background = augment_background
        self.device = _device(device)
        self._generator = torch.Generator().manual_seed(seed)
        self._params = None

    def fit(self, I):
        self.image_shape = I.shape
        x = _tensor(I, self.device)
        self._params = F.stain_augment_fit(x, method=self.method)
        if bool(torch.isnan(self._params.stain_matrix).any()):
            raise TissueMaskException("Empty tissue mask computed")
        self.stain_matrix = self._params.stain_matrix.cpu().numpy()
        self.source_concentrations = self._params.concentrations.cpu().numpy(
        ).reshape(-1, 2)
        self.n_stains = 2
        self.tissue_mask = self._params.mask.cpu().numpy().ravel()
        # Fit-once/pop-many fused route (augmenter.py:416-448 contract): on
        # a CUDA device, for a lane-aligned image up to 512^2, keep the
        # planar tile and the fitted matrix on the card, so every pop() is
        # one pass of the augment-apply kernel K7 (functional.py:193-209).
        self._fused_state = None
        n_pixels = I.shape[0] * I.shape[1]
        if (self.device.type == "cuda" and n_pixels % 128 == 0
                and n_pixels <= 512 * 512):
            u8 = x if x.dtype == torch.uint8 else to_uint8(x)
            self._fused_state = F.FusedStainAugmentState(
                planar=to_planar(u8[None]).contiguous(),
                stain_matrix=self._params.stain_matrix[None],
                h=I.shape[0], w=I.shape[1])

    def pop(self):
        if self._params is None:
            raise RuntimeError("Call fit(I) before pop().")
        if self._fused_state is not None:
            out = F.stain_augment_pop_fused(
                self._fused_state, self._generator, self.sigma1,
                self.sigma2, self.augment_background)[0]
        else:
            out = F.stain_augment_pop(self._params, self._generator,
                                      self.sigma1, self.sigma2,
                                      self.augment_background)
        return out.cpu().numpy()
