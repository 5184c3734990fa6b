"""Color-space conversions as batched torch functions.

Port of the JAX package's ``ops/colorspace.py`` (the sRGB <-> CIELAB, OD,
HED, grayscale, HSD and uint8-edge parts), which replaces the reference's OpenCV
``cv.cvtColor(RGB2LAB/LAB2RGB)`` calls (``stainlib/utils/
stain_utils.py:41,62,66,152,172``), ``convert_RGB_to_OD`` /
``convert_OD_to_RGB`` (``stain_utils.py:101-124``) and scikit-image's
``rgb2hed`` / ``hed2rgb`` / ``rgb2gray`` (``stainlib/augmentation/
augmenter.py:295,319,397``) with the same constants.

Images are float32 tensors with a trailing channel axis and RGB in
``[0, 255]``; every function broadcasts over leading axes and runs on the
device of its input. The 3x3 (and 3x1) contractions, the JAX module's
``_mm`` at ``Precision.HIGHEST`` (``colorspace.py:31-37``), are written as
float32 multiplies and adds in a fixed order (:func:`_contract`), not as
``@``: a matrix product rounds differently on the card than on the CPU,
separate elementwise multiplies and adds round the same on both. The
transcendentals (``pow``, ``log``, ``exp``) are evaluated in float64 and
rounded once to float32 (``ops.fdiv.f64``): CUDA's float32 ``powf``,
``logf`` and ``expf`` and the CPU's round differently in the last bit,
their float64 results round to the same float32. Where the input is uint8,
the per-channel transcendental (the ``log`` of :func:`rgb_to_od` and
:func:`rgb_to_hed`, the gamma ``pow`` of :func:`rgb_to_lab` and
:func:`lab_luminance`) has 256 possible values: a table built once by the
float path's own expression, then gathered (:func:`_per_byte`), with the
same bits and no float64 pass over the image.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stainlib_tpu_torch.ops.fdiv import f64, fdiv, sum3

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

# Ruifrok & Johnston's normalized stain OD vectors (rows: Haematoxylin,
# Eosin, DAB), skimage's ``rgb_from_hed``: row-normalized in float64, then
# inverted, as the JAX module does (``colorspace.py:164-174``).
_RGB_FROM_HED = np.array([[0.65, 0.70, 0.29],
                          [0.07, 0.99, 0.11],
                          [0.27, 0.57, 0.78]], dtype=np.float64)
_RGB_FROM_HED /= np.linalg.norm(_RGB_FROM_HED, axis=1, keepdims=True)
_HED_FROM_RGB = np.linalg.inv(_RGB_FROM_HED)
_LOG_ADJUST = float(np.log(1e-6))  # skimage's log-domain scaling constant

# skimage's ``rgb2gray`` luma weights.
_GRAY_WEIGHTS = np.array([0.2125, 0.7154, 0.0721], dtype=np.float32)


def _contract(x, m):
    """``x @ m`` for ``x`` (..., 3) and a constant (3, K) matrix ``m``:
    output k is ``x0*m[0,k] + x1*m[1,k] + x2*m[2,k]``, each product and sum
    rounded in float32 from left to right, with ``m`` rounded once to
    float32. (3,) ``m`` gives (...,)."""
    m = np.asarray(m, np.float32)
    cols = m[:, None] if m.ndim == 1 else m
    out = [x[..., 0] * float(cols[0, k]) + x[..., 1] * float(cols[1, k])
           + x[..., 2] * float(cols[2, k]) for k in range(cols.shape[1])]
    return out[0] if m.ndim == 1 else torch.stack(out, dim=-1)


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _byte_table(fn, device):
    """``fn`` over the 256 byte values as float32, built on the CPU and
    copied, once per function and device."""
    return fn(torch.arange(256, dtype=torch.float32)).to(device)


def _per_byte(fn, rgb):
    """``fn(rgb.float())`` for an elementwise ``fn``: for uint8 ``rgb`` a
    gather from ``fn``'s 256-entry table, else ``fn`` itself."""
    rgb = torch.as_tensor(rgb)
    if rgb.dtype == torch.uint8:
        return _byte_table(fn, rgb.device)[rgb.to(torch.int32)]
    return fn(rgb.to(torch.float32))


def _cbrt(x):
    # torch has no cbrt; every caller selects this branch only where x > 0.
    return f64(torch.pow, x, 1.0 / 3.0)


def _srgb_gamma_expand(c):
    """sRGB electro-optical transfer: gamma-encoded [0,1] -> linear [0,1]."""
    return torch.where(c <= 0.04045, fdiv(c, 12.92),
                       f64(torch.pow, fdiv(c + 0.055, 1.055), 2.4))


def _srgb_gamma_compress(c):
    """Linear [0,1] -> gamma-encoded sRGB [0,1]."""
    c = torch.clamp_min(c, 0.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * f64(torch.pow, c, 1.0 / 2.4) - 0.055)


def _lab_f(t):
    return torch.where(t > _LAB_DELTA, _cbrt(t), 7.787 * t + 16.0 / 116.0)


def _lab_f_inv(ft):
    t3 = ft ** 3
    return torch.where(t3 > _LAB_DELTA, t3, fdiv(ft - 16.0 / 116.0, 7.787))


def _linear_of_byte_scale(x):
    """A channel in [0,255] -> linear [0,1]."""
    return _srgb_gamma_expand(fdiv(x, 255.0))


def rgb_to_lab(rgb):
    """sRGB in [0,255] -> CIELAB (L in [0,100]); OpenCV's 8-bit
    ``COLOR_RGB2LAB`` (``stain_utils.py:41``) with its packing undone."""
    lin = _per_byte(_linear_of_byte_scale, rgb)
    xyz = _contract(lin, _RGB2XYZ.T)
    xyz = xyz / _f32(_WHITE, lin.device)
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
    lin = _contract(xyz, _XYZ2RGB.T)
    srgb = _srgb_gamma_compress(lin)
    return torch.clamp(srgb, 0.0, 1.0) * 255.0


def lab_luminance(rgb):
    """L channel of CIELAB in [0,100]; the reference's tissue-mask
    statistic (``stain_utils.py:41-43``: uint8 L / 255 == L / 100)."""
    lin = _per_byte(_linear_of_byte_scale, rgb)
    Y = _contract(lin, _RGB2XYZ.T[:, 1])
    return torch.where(Y > _LAB_DELTA, 116.0 * _cbrt(Y) - 16.0,
                       _LAB_KAPPA * Y)


def _od_of_channel(x):
    return torch.clamp_min(
        -f64(torch.log, fdiv(torch.clamp_min(x, 1.0), 255.0)), 1e-6)


def rgb_to_od(rgb):
    """RGB [0,255] -> optical density ``max(-log(max(I,1)/255), 1e-6)``
    (``convert_RGB_to_OD``, ``stain_utils.py:101-112``)."""
    return _per_byte(_od_of_channel, rgb)


def od_to_rgb(od):
    """Optical density -> RGB float in (0, 255], ``255 * exp(-max(OD,
    1e-6))`` (``convert_OD_to_RGB``, ``stain_utils.py:114-124``, without the
    uint8 cast)."""
    od = torch.clamp_min(torch.as_tensor(od).to(torch.float32), 1e-6)
    return 255.0 * f64(torch.exp, -od)


def _hed_log_of_channel(x):
    c = torch.clamp_min(fdiv(x, 255.0), 1e-6)
    return fdiv(f64(torch.log, c), _LOG_ADJUST)


def rgb_to_hed(rgb):
    """RGB [0,255] -> HED stain concentrations, skimage ``rgb2hed``
    (``augmenter.py:295``): ``(log(max(rgb/255, 1e-6)) / log(1e-6)) @
    hed_from_rgb``."""
    return _contract(_per_byte(_hed_log_of_channel, rgb), _HED_FROM_RGB)


def hed_to_rgb(hed):
    """HED stain concentrations -> RGB float [0,255], skimage ``hed2rgb``
    (``augmenter.py:319``): ``clip(exp(-(hed * -log(1e-6)) @
    rgb_from_hed), 0, 1) * 255``."""
    hed = torch.as_tensor(hed).to(torch.float32)
    log_rgb = -_contract(hed * (-_LOG_ADJUST), _RGB_FROM_HED)
    return torch.clamp(f64(torch.exp, log_rgb), 0.0, 1.0) * 255.0


def rgb_to_gray(rgb):
    """RGB [0,255] -> luma [0,1] with skimage's ``rgb2gray`` weights
    (``augmenter.py:397``)."""
    return _contract(fdiv(torch.as_tensor(rgb).to(torch.float32), 255.0),
                     _GRAY_WEIGHTS)


def rgb_to_hsd(rgb, eps: float = 1e-6):
    """RGB [0,255] -> HSD ``(cx, cy, D)`` (hue-saturation-density, van der
    Laak et al. 2000; ``colorspace.py:218-234``), the color model of the
    flow pipeline: per-channel density ``D_ch = -log(I_ch/255)`` with
    ``I`` clipped to [1, 254], overall density ``D = max(mean(D_ch),
    eps)``, chromatic coordinates ``cx = D_R/D - 1`` and ``cy = (D_G -
    D_B) / (sqrt(3) * D)``."""
    I = fdiv(torch.clamp(torch.as_tensor(rgb).to(torch.float32), 1.0,
                         254.0), 255.0)
    od = -f64(torch.log, I)
    D = torch.clamp_min(fdiv(sum3(od), 3.0), eps)
    cx = od[..., 0] / D - 1.0
    cy = (od[..., 1] - od[..., 2]) / (float(np.float32(np.sqrt(3.0))) * D)
    return torch.stack([cx, cy, D], dim=-1)


def hsd_to_rgb(hsd):
    """HSD ``(cx, cy, D)`` -> RGB float [0,255], the inverse of
    :func:`rgb_to_hsd` (``colorspace.py:237-250``)."""
    hsd = torch.as_tensor(hsd).to(torch.float32)
    cx, cy, D = hsd[..., 0], hsd[..., 1], hsd[..., 2]
    s3 = float(np.float32(np.sqrt(3.0)))
    od_r = D * (cx + 1.0)
    od_g = 0.5 * D * (2.0 - cx + s3 * cy)
    od_b = 0.5 * D * (2.0 - cx - s3 * cy)
    od = torch.stack([od_r, od_g, od_b], dim=-1)
    return torch.clamp(f64(torch.exp, -od), 0.0, 1.0) * 255.0


def to_uint8(x):
    """Clip to [0,255] and truncate to uint8 — the pipeline-edge
    quantization (``.astype(np.uint8)`` semantics)."""
    return torch.clamp(x, 0.0, 255.0).to(torch.uint8)
