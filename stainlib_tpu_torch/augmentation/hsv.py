"""HSV color jitter, batched.

Port of the JAX package's ``augmentation/hsv.py``: hue rotation and
saturation/value scaling (the 'HSV-light/strong' augmenters of Tellez et
al. 2019), the in-training-loop partner of HED jitter in ``BASELINE.json``
config #3. RGB <-> HSV is written inline, as there.
"""

from __future__ import annotations

import torch

from stainlib_tpu_torch.augmentation.functional import _uniform
from stainlib_tpu_torch.ops.colorspace import to_uint8
from stainlib_tpu_torch.ops.fdiv import fdiv


def _mod1(x):
    """``x % 1.0`` with the sign of the divisor, as ``jnp.remainder``:
    ``fmod``, then +1 where it is negative."""
    m = torch.fmod(x, 1.0)
    return torch.where(m < 0.0, m + 1.0, m)


def rgb_to_hsv(rgb01):
    """RGB [0,1] -> (h in [0,1), s, v)."""
    r, g, b = rgb01[..., 0], rgb01[..., 1], rgb01[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    delta = mx - mn
    safe = torch.where(delta > 0, delta, 1.0)
    h = torch.where(mx == r, (g - b) / safe,
                    torch.where(mx == g, 2.0 + (b - r) / safe,
                                4.0 + (r - g) / safe))
    h = torch.where(delta > 0, _mod1(fdiv(h, 6.0)), 0.0)
    s = torch.where(mx > 0, delta / torch.clamp_min(mx, 1e-12), 0.0)
    return torch.stack([h, s, mx], dim=-1)


def hsv_to_rgb(hsv):
    """(h in [0,1), s, v) -> RGB [0,1]."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6

    def select(*vals):
        out = torch.zeros_like(v)
        for k, val in enumerate(vals):
            out = torch.where(i == k, val, out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def _hsv_jitter_apply(rgb, dh, ds, dv):
    """Given per-image hue shifts and saturation/value scales."""
    x = fdiv(torch.as_tensor(rgb).to(torch.float32), 255.0)
    hsv = rgb_to_hsv(x)
    h = _mod1(hsv[..., 0] + dh[..., None, None])
    s = torch.clamp(hsv[..., 1] * ds[..., None, None], 0.0, 1.0)
    v = torch.clamp(hsv[..., 2] * dv[..., None, None], 0.0, 1.0)
    out = hsv_to_rgb(torch.stack([h, s, v], dim=-1))
    return to_uint8(out * 255.0)


def hsv_jitter(rgb, generator=None, hue_shift: float = 0.05,
               sat_range: float = 0.1, val_range: float = 0.1):
    """Per-image hue shift ~U(+-hue_shift), then saturation and value
    scales ~U(1+-range). (..., H, W, 3) RGB [0,255] in -> uint8 out."""
    rgb = torch.as_tensor(rgb)
    lead, dev = rgb.shape[:-3], rgb.device
    dh = _uniform(generator, lead, -hue_shift, hue_shift, dev)
    ds = _uniform(generator, lead, 1 - sat_range, 1 + sat_range, dev)
    dv = _uniform(generator, lead, 1 - val_range, 1 + val_range, dev)
    return _hsv_jitter_apply(rgb, dh, ds, dv)


def hsv_light(rgb, generator=None):
    """Light preset (Tellez et al. 'HSV-light')."""
    return hsv_jitter(rgb, generator, 0.05, 0.1, 0.1)


def hsv_strong(rgb, generator=None):
    """Strong preset ('HSV-strong'): full hue rotation."""
    return hsv_jitter(rgb, generator, 0.5, 0.5, 0.35)
