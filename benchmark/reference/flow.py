"""The plain reference of the flow + GMM colour model's deploy recolour.

Written from the published description of the colour model
(``dlmodels/color-information/train_img_horo.py`` of
https://github.com/sebastianffx/stainlib: the model built at ``:289,
321,324-358``, the loss wiring at ``:466-501``, the deploy loop at
``:658-930``; Residual Flows, Chen et al. 2019, arXiv:1906.02735), in plain
torch and float32, one operation after another, with no kernels and no
batching tricks. It imports nothing of either package of this repository.

* RGB -> HSD (van der Laak et al. 2000): ``I`` clipped to [1, 254] over
  255, ``OD = -log I`` per channel, ``D = max(mean OD, 1e-6)``, ``cx =
  OD_R / D - 1``, ``cy = (OD_G - OD_B) / (sqrt 3 D)``; and back.
* The flow on the density ``D / 4`` clipped to (1e-4, 1 - 1e-4): the logit
  transform ``logit(a + (1 - 2a) x)``, ``a = 1e-5``; per scale, blocks of
  ActNorm ``(x - b) exp(logs)`` then ``x + g(x)``, g the 3-1-3 branch
  conv -> swish / 1.1 -> conv -> swish / 1.1 -> conv whose kernels are
  scaled by ``min(1, coeff / sigma)``; a 2x2 squeeze between scales.
* The GMM head: the chroma ``(cx, cy)`` average-pooled to the latent grid,
  three 3x3 convolutions with ReLU between, a softmax over the classes,
  upsampled to the image grid by nearest neighbour: gamma.
* The per-class statistics ``mu_k = sum gamma_k x / sum gamma_k``,
  ``sigma_k = sqrt(sum gamma_k x^2 / sum gamma_k - mu_k^2)``, and the diag
  transfer ``sum_k gamma_k ((x - mu_src_k) / sigma_src_k sigma_tmpl_k +
  mu_tmpl_k)``, back to RGB and truncated to uint8 (``:815``).

Departures, each the port's choice where the published code is silent or
missing (its ``lib/`` is not in the repository):

* the squeeze puts input channel ``c`` of sub-pixel ``(dy, dx)`` on
  channel ``(2 dy + dx) C + c``, the port's order;
* the GMM head conditions on the chroma alone, as the port's ``ConvGMM``
  does: gamma does not read the flow's latent, so :func:`recolor` runs no
  flow, and the flow is held to the port by :func:`latent`;
* the statistics' sums run in float64; ``sigma``'s variance and
  ``sum gamma`` are floored at 1e-6, the source ``sigma`` at 1e-6 in the
  transfer;
* the flow's log-determinant is not computed: deployment reads no bits/dim.

``low`` (a torch dtype or None) is the control's knob, as in
``reference/ops.py``: every layer's output is rounded through it. The
control also runs its convolutions in TF32 (``calibrate.tf32``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-6
LOGIT_ALPHA = 1e-5


def lowp(x, low):
    """``x`` rounded through the dtype ``low`` and back (None: ``x``)."""
    return x if low is None else x.to(low).to(x.dtype)


def rgb_to_hsd(u8, low=None):
    """uint8 RGB (..., 3) -> HSD (..., 3) = (cx, cy, D), float32."""
    i = torch.clamp(u8.to(torch.float32), 1.0, 254.0) / 255.0
    od = -torch.log(i)
    d = torch.clamp_min((od[..., 0] + od[..., 1] + od[..., 2]) / 3.0, EPS)
    cx = od[..., 0] / d - 1.0
    cy = (od[..., 1] - od[..., 2]) / (math.sqrt(3.0) * d)
    return lowp(torch.stack([cx, cy, d], dim=-1), low)


def hsd_to_rgb_u8(hsd, low=None):
    """HSD (..., 3) -> RGB, truncated to uint8."""
    cx, cy, d = hsd[..., 0], hsd[..., 1], hsd[..., 2]
    s3 = math.sqrt(3.0)
    od = torch.stack([d * (cx + 1.0), 0.5 * d * (2.0 - cx + s3 * cy),
                      0.5 * d * (2.0 - cx - s3 * cy)], dim=-1)
    rgb = lowp(torch.clamp(torch.exp(-od), 0.0, 1.0) * 255.0, low)
    return torch.clamp(rgb, 0.0, 255.0).to(torch.uint8)


def _squeeze(x):
    return torch.cat([x[:, :, dy::2, dx::2] for dy in (0, 1)
                      for dx in (0, 1)], dim=1)


def _swish(x):
    return x * torch.sigmoid(x) / 1.1


def latent(u8, weights, cfg: dict, low=None):
    """The flow's latent z (B, C', H', W') of uint8 tiles (B, S, S, 3)."""
    flow, spectral = weights[0]["flow"], weights[1]
    d = rgb_to_hsd(u8, low)[..., 2]
    x = torch.clamp(d / 4.0, 1e-4, 1.0 - 1e-4)[:, None]
    x = lowp(torch.logit(LOGIT_ALPHA + (1.0 - 2.0 * LOGIT_ALPHA) * x), low)
    for s in range(cfg["n_scales"]):
        if s:
            x = _squeeze(x)
        for b in range(cfg["blocks_per_scale"]):
            norm = f"norms.{s}.{b}"
            x = lowp((x - flow[norm + ".bias"][:, None, None])
                     * torch.exp(flow[norm + ".logs"])[:, None, None], low)
            y = x
            for i in range(3):
                conv = f"scales.{s}.{b}.g.convs.{i}"
                w = flow[conv + ".weight"]
                w = w * min(1.0, cfg["coeff"] / float(spectral[conv + ".sigma"]))
                y = lowp(F.conv2d(y, w, flow[conv + ".bias"],
                                  padding=w.shape[-1] // 2), low)
                if i < 2:
                    y = lowp(_swish(y), low)
            x = lowp(x + y, low)
    return x


def gamma(hsd, latent_hw, weights, low=None):
    """The GMM head's responsibilities (B, H, W, K) on the image grid of
    ``hsd`` (B, H, W, 3), the head run on the ``latent_hw`` grid."""
    gmm = weights[0]["gmm"]
    h, w = hsd.shape[1:3]
    x = hsd[..., :2].permute(0, 3, 1, 2)
    x = lowp(F.avg_pool2d(x, h // latent_hw[0]), low)
    n = sum(1 for k in gmm if k.endswith(".weight"))
    for i in range(n):
        x = lowp(F.conv2d(x, gmm[f"convs.{i}.weight"],
                          gmm[f"convs.{i}.bias"], padding=1), low)
        if i < n - 1:
            x = torch.relu(x)
    g = lowp(torch.softmax(x, dim=1), low)
    g = F.interpolate(g, size=(h, w), mode="nearest")
    return g.permute(0, 2, 3, 1)


def latent_hw(cfg: dict, side: int):
    f = 2 ** (cfg["n_scales"] - 1)
    return side // f, side // f


def stats(u8, weights, cfg: dict, low=None):
    """The per-class (mu, sigma), each (K, 3), of uint8 tiles."""
    hsd = rgb_to_hsd(u8, low)
    g = gamma(hsd, latent_hw(cfg, hsd.shape[1]), weights, low)
    w = g.reshape(-1, g.shape[-1]).double()
    x = hsd.reshape(-1, 3).double()
    tot = torch.clamp_min(w.sum(0), EPS)[:, None]
    mu = (w.T @ x) / tot
    var = torch.clamp_min((w.T @ (x * x)) / tot - mu * mu, EPS)
    return mu.float(), torch.sqrt(var).float()


def recolor(u8, weights, cfg: dict, source, template, low=None):
    """uint8 tiles (B, S, S, 3) recoloured by the diag transfer from the
    source's (mu, sigma) to the template's."""
    (mu_s, sd_s), (mu_t, sd_t) = source, template
    hsd = rgb_to_hsd(u8, low)
    g = gamma(hsd, latent_hw(cfg, hsd.shape[1]), weights, low)
    sd_s = torch.clamp_min(sd_s, EPS)
    maps = (hsd[..., None, :] - mu_s) / sd_s * sd_t + mu_t  # (B,H,W,K,3)
    out = lowp((g[..., None] * maps).sum(-2), low)
    return hsd_to_rgb_u8(out, low)
