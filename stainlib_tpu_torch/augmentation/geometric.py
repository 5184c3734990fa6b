"""Batched geometric augmentation: homography-composed affine warps.

Port of the JAX package's ``augmentation/geometric.py``, the batched
re-design of the DANN pipeline's Keras-style geometric augmentation
(``dlmodels/stain_adversarial_learning/utils/keras_utils.py:40-158``):
per-sample rotation / shift / shear / zoom composed as one center-offset
affine homography, bilinear sampling with nearest-edge fill, per-channel
intensity shift and random flips; plus the crop helpers
(``keras_utils.py:21-37``) and the dihedral flips/rotations of the balanced
patch generators (``utils_patches.py:95-118``).

The warp is a plain torch bilinear gather with edge clamping, the
arithmetic of ``jax.scipy.ndimage.map_coordinates(order=1,
mode="nearest")`` in its order; the 3x3 products are written as multiplies
and adds in a fixed order, so the card and the CPU round them the same.
"""

from __future__ import annotations

import math

import torch

from stainlib_tpu_torch.augmentation.functional import _uniform


def _matmul3(a, b):
    """(..., 3, 3) @ (..., 3, 3), each entry ``a_i0 b_0j + a_i1 b_1j +
    a_i2 b_2j`` rounded left to right."""
    rows = [torch.stack([a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j]
                         + a[..., i, 2] * b[..., 2, j] for j in range(3)], -1)
            for i in range(3)]
    return torch.stack(rows, dim=-2)


def _affine_matrices(h: int, w: int, theta_deg, tx_frac, ty_frac, shear_deg,
                     zoom):
    """(B, 3, 3) homographies from the per-sample draws
    (``geometric.py:25-59``): rotation, shift (fractions of h and w), shear
    (degrees), zoom (B, 2), composed about the image center."""
    deg = math.pi / 180.0
    theta, shear = theta_deg * deg, shear_deg * deg
    tx, ty = tx_frac * h, ty_frac * w
    one, zero = torch.ones_like(theta), torch.zeros_like(theta)

    def mat(*rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    c, s = torch.cos(theta), torch.sin(theta)
    rotation = mat((c, -s, zero), (s, c, zero), (zero, zero, one))
    shift = mat((one, zero, tx), (zero, one, ty), (zero, zero, one))
    shear_m = mat((one, -torch.sin(shear), zero),
                  (zero, torch.cos(shear), zero), (zero, zero, one))
    zoom_m = mat((zoom[:, 0], zero, zero), (zero, zoom[:, 1], zero),
                 (zero, zero, one))
    m = _matmul3(_matmul3(_matmul3(rotation, shift), shear_m), zoom_m)
    ox, oy = h / 2.0 - 0.5, w / 2.0 - 0.5
    offset = mat((one, zero, one * ox), (zero, one, one * oy),
                 (zero, zero, one))
    reset = mat((one, zero, one * -ox), (zero, one, one * -oy),
                (zero, zero, one))
    return _matmul3(_matmul3(offset, m), reset)


def _warp(x, matrices):
    """(B, H, W, C) float images, output(r) = input(M @ r): bilinear, with
    the sample indices clamped to the edge (``_warp_one``,
    ``geometric.py:62-80``)."""
    B, h, w, _ = x.shape
    m = matrices.to(x.device)[:, :, :, None, None]
    R = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
    C = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
    src_r = m[:, 0, 0] * R + m[:, 0, 1] * C + m[:, 0, 2]
    src_c = m[:, 1, 0] * R + m[:, 1, 1] * C + m[:, 1, 2]

    def nodes(coord, size):
        lower = torch.floor(coord)
        upper_w = coord - lower
        i = lower.to(torch.int64)
        return [(torch.clamp(i, 0, size - 1), 1 - upper_w),
                (torch.clamp(i + 1, 0, size - 1), upper_w)]

    b = torch.arange(B, device=x.device)[:, None, None]
    out = None
    for ir, wr in nodes(src_r, h):
        for ic, wc in nodes(src_c, w):
            term = (wr * wc)[..., None] * x[b, ir, ic]
            out = term if out is None else out + term
    return out


def _random_geometric_apply(rgb, matrices, shifts=None, hflip=None,
                            vflip=None):
    """Warp by the given (B, 3, 3) homographies, then add (B, 3) channel
    shifts and flip the images whose (B,) flags are set."""
    out = _warp(torch.as_tensor(rgb).to(torch.float32), matrices)
    if shifts is not None:
        out = out + shifts.to(out.device)[:, None, None, :]
    if hflip is not None:
        out = torch.where(hflip.to(out.device)[:, None, None, None],
                          out.flip(2), out)
    if vflip is not None:
        out = torch.where(vflip.to(out.device)[:, None, None, None],
                          out.flip(1), out)
    return out


def random_geometric(
    rgb,
    generator: torch.Generator | None = None,
    rotation_range: float = 0.0,
    width_shift_range: float = 0.0,
    height_shift_range: float = 0.0,
    shear_range: float = 0.0,
    zoom_range: float = 0.0,
    channel_shift_range: float = 0.0,
    horizontal_flip: bool = False,
    vertical_flip: bool = False,
):
    """Per-sample random affine + channel shift + flips over (B, H, W, C).

    Float in, float out (same value range as the input; the reference works
    on float32 patches). Draws per sample: rotation, height shift, width
    shift, shear, zoom (2), then the channel shift (3) and the flips when
    enabled."""
    x = torch.as_tensor(rgb)
    B, h, w, _ = x.shape

    def draw(shape, lo, hi):
        return _uniform(generator, shape, lo, hi, x.device)

    theta = draw((B,), -rotation_range, rotation_range)
    tx = draw((B,), -height_shift_range, height_shift_range)
    ty = draw((B,), -width_shift_range, width_shift_range)
    shear = draw((B,), -shear_range, shear_range)
    zoom = draw((B, 2), 1.0 - zoom_range, 1.0 + zoom_range)
    shifts = (draw((B, 3), -channel_shift_range, channel_shift_range)
              if channel_shift_range else None)
    hflip = draw((B,), 0.0, 1.0) < 0.5 if horizontal_flip else None
    vflip = draw((B,), 0.0, 1.0) < 0.5 if vertical_flip else None
    matrices = _affine_matrices(h, w, theta, tx, ty, shear, zoom)
    return _random_geometric_apply(x, matrices, shifts, hflip, vflip)


def _random_flips_rots_apply(rgb, codes):
    """Member ``codes[b]`` of the dihedral group D4 per sample: rotate by
    ``code % 4`` quarter turns, then flip left-right if ``code >= 4``."""
    x = torch.as_tensor(rgb)
    out = []
    for img, code in zip(x, codes.tolist()):
        rot = torch.rot90(img, code % 4, dims=(0, 1))
        out.append(rot.flip(1) if code >= 4 else rot)
    return torch.stack(out)


def random_flips_rots(rgb, generator=None):
    """Random member of D4 per sample: the flips + 90-degree rotations the
    balanced generators apply (``utils_patches.py:95-118``); square
    images."""
    x = torch.as_tensor(rgb)
    codes = _randint(generator, 8, x.shape[0])
    return _random_flips_rots_apply(x, codes)


def center_crop(rgb, target: int):
    """Center crop to (target, target) (``center_cropping``,
    ``utils_patches.py:21-30``)."""
    h, w = rgb.shape[-3], rgb.shape[-2]
    r0 = h // 2 - target // 2
    c0 = w // 2 - target // 2
    return rgb[..., r0:r0 + target, c0:c0 + target, :]


def _random_crop_apply(rgb, r0, c0, target: int):
    x = torch.as_tensor(rgb)
    return torch.stack([img[r:r + target, c:c + target]
                        for img, r, c in zip(x, r0.tolist(), c0.tolist())])


def _randint(generator, high: int, n: int):
    gdev = generator.device if generator is not None else torch.device("cpu")
    return torch.randint(0, high, (n,), generator=generator, device=gdev)


def random_crop(rgb, generator, target: int):
    """Random crop per sample to (target, target) (``random_crop``,
    ``keras_utils.py:21-30``); ``generator`` may be None."""
    x = torch.as_tensor(rgb)
    B, h, w, _ = x.shape
    r0 = _randint(generator, h - target + 1, B)
    c0 = _randint(generator, w - target + 1, B)
    return _random_crop_apply(x, r0, c0, target)
