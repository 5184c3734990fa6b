"""Color-space conversions as batched torch functions.

Port of the JAX package's ``ops/colorspace.py`` (the sRGB <-> CIELAB, OD and
uint8-edge parts), which replaces the reference's OpenCV
``cv.cvtColor(RGB2LAB/LAB2RGB)`` calls (``stainlib/utils/
stain_utils.py:41,62,66,152,172``) and ``convert_RGB_to_OD``
(``stain_utils.py:101-112``) with OpenCV's constants.

Images are float32 tensors with a trailing channel axis and RGB in
``[0, 255]``; every function broadcasts over leading axes and runs on the
device of its input. The 3x3 contractions run in float32 with TF32 off
(set once at package import), the counterpart of the JAX module's
``Precision.HIGHEST`` (``colorspace.py:31-37``).
"""

from __future__ import annotations

import numpy as np
import torch

from stainlib_tpu_torch.ops.fdiv import fdiv

# OpenCV's RGB->XYZ matrix (ITU-R BT.709 primaries, D65).
_RGB2XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ).astype(np.float32)
# D65 reference white used by OpenCV (X_n, Y_n, Z_n).
_WHITE = np.array([0.950456, 1.0, 1.088754], dtype=np.float32)

_LAB_DELTA = 0.008856  # (6/29)^3 threshold of the CIE f() function
_LAB_KAPPA = 903.3  # OpenCV's low-Y L* slope


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _cbrt(x):
    # torch has no cbrt; every caller selects this branch only where x > 0.
    return torch.pow(x, 1.0 / 3.0)


def _srgb_gamma_expand(c):
    """sRGB electro-optical transfer: gamma-encoded [0,1] -> linear [0,1]."""
    return torch.where(c <= 0.04045, fdiv(c, 12.92),
                       fdiv(c + 0.055, 1.055) ** 2.4)


def _srgb_gamma_compress(c):
    """Linear [0,1] -> gamma-encoded sRGB [0,1]."""
    c = torch.clamp_min(c, 0.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * c ** (1.0 / 2.4) - 0.055)


def _lab_f(t):
    return torch.where(t > _LAB_DELTA, _cbrt(t), 7.787 * t + 16.0 / 116.0)


def _lab_f_inv(ft):
    t3 = ft ** 3
    return torch.where(t3 > _LAB_DELTA, t3, fdiv(ft - 16.0 / 116.0, 7.787))


def rgb_to_lab(rgb):
    """sRGB in [0,255] -> CIELAB (L in [0,100]); OpenCV's 8-bit
    ``COLOR_RGB2LAB`` (``stain_utils.py:41``) with its packing undone."""
    c = fdiv(torch.as_tensor(rgb).to(torch.float32), 255.0)
    lin = _srgb_gamma_expand(c)
    xyz = lin @ _f32(_RGB2XYZ.T, c.device)
    xyz = xyz / _f32(_WHITE, c.device)
    fx, fy, fz = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    L = torch.where(fy > _LAB_DELTA, 116.0 * _cbrt(fy) - 16.0,
                    _LAB_KAPPA * fy)
    fx, fy, fz = _lab_f(fx), _lab_f(fy), _lab_f(fz)
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return torch.stack([L, a, b], dim=-1)


def lab_to_rgb(lab):
    """CIELAB (L in [0,100]) -> sRGB float in [0,255], clipped; OpenCV
    ``COLOR_LAB2RGB`` (``stain_utils.py:66,172``) up to 8-bit quantization."""
    lab = torch.as_tensor(lab).to(torch.float32)
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = fdiv(L + 16.0, 116.0)
    fx = fy + fdiv(a, 500.0)
    fz = fy - fdiv(b, 200.0)
    y = torch.where(L > _LAB_KAPPA * _LAB_DELTA, fy ** 3,
                    fdiv(L, _LAB_KAPPA))
    x = _lab_f_inv(fx)
    z = _lab_f_inv(fz)
    xyz = torch.stack([x, y, z], dim=-1) * _f32(_WHITE, lab.device)
    lin = xyz @ _f32(_XYZ2RGB.T, lab.device)
    srgb = _srgb_gamma_compress(lin)
    return torch.clamp(srgb, 0.0, 1.0) * 255.0


def lab_luminance(rgb):
    """L channel of CIELAB in [0,100]; the reference's tissue-mask
    statistic (``stain_utils.py:41-43``: uint8 L / 255 == L / 100)."""
    c = fdiv(torch.as_tensor(rgb).to(torch.float32), 255.0)
    lin = _srgb_gamma_expand(c)
    Y = lin @ _f32(_RGB2XYZ.T[:, 1], c.device)
    return torch.where(Y > _LAB_DELTA, 116.0 * _cbrt(Y) - 16.0,
                       _LAB_KAPPA * Y)


def rgb_to_od(rgb):
    """RGB [0,255] -> optical density ``max(-log(max(I,1)/255), 1e-6)``
    (``convert_RGB_to_OD``, ``stain_utils.py:101-112``)."""
    I = torch.clamp_min(torch.as_tensor(rgb).to(torch.float32), 1.0)
    return torch.clamp_min(-torch.log(fdiv(I, 255.0)), 1e-6)


def to_uint8(x):
    """Clip to [0,255] and truncate to uint8 — the pipeline-edge
    quantization (``.astype(np.uint8)`` semantics)."""
    return torch.clamp(x, 0.0, 255.0).to(torch.uint8)
