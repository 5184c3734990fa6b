"""Deep convolutional GMM head over flow latents (DCGMM-style).

Port of the JAX package's ``models/gmm.py`` (the reference's
``lib.GMM.GMM_model``, called at ``train_img_horo.py:363,492,703-705``): a
small CNN on the HSD chroma gives per-pixel tissue-class responsibilities
gamma (softmax over ``n_clusters``); class k has a learned mean mu_k and
scale sigma_k for the flow latent; the latent log-density is the per-pixel
log mixture

    logpz = sum_pixels log sum_k gamma_k * N(z_pixel; mu_k, sigma_k)

Returns ``(logpz, (mu, sigma, gamma))``, gamma NCHW: (B, K, H, W).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled so that its variance is 1 / fan_in.
_TRUNC_STD = 0.87962566103423978
_LOG_2PI = float(np.log(np.float32(2.0 * np.pi)))


def _lecun_conv(c_in: int, c_out: int, device, generator) -> nn.Conv2d:
    conv = torch.nn.utils.skip_init(nn.Conv2d, c_in, c_out, 3, padding=1,
                                    device=device or "cpu")
    std = math.sqrt(1.0 / (9 * c_in)) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        conv.bias.zero_()
    return conv


class ConvGMM(nn.Module):
    """Per-pixel mixture density over a C-channel latent field.

    mu and log_sigma are (n_clusters, latent_channels): with one latent
    channel, as the trainer builds it, each class's mean and scale are
    shared by every channel of a squeezed latent."""

    def __init__(self, n_clusters: int = 4, hidden: int = 32,
                 n_layers: int = 3, latent_channels: int = 1,
                 cond_channels: int = 2, device=None, generator=None):
        super().__init__()
        ins = [cond_channels] + [hidden] * (n_layers - 1)
        outs = [hidden] * (n_layers - 1) + [n_clusters]
        self.convs = nn.ModuleList(_lecun_conv(i, o, device, generator)
                                   for i, o in zip(ins, outs))
        self.mu = nn.Parameter(
            torch.linspace(-1.0, 1.0, n_clusters, device=device)[:, None]
            * torch.ones(latent_channels, device=device))
        self.log_sigma = nn.Parameter(
            torch.zeros(n_clusters, latent_channels, device=device))

    def forward(self, z, x_cond):
        """``z``: (B, Cz, H, W) flow latents; ``x_cond``: (B, Cc, H', W')
        conditioning image (HSD chroma in the reference pipeline), average-
        pooled down to the latent grid when finer.

        Returns (logpz (B,), (mu, sigma, gamma)), gamma (B, K, H, W) at the
        latent grid."""
        h = x_cond
        factor = x_cond.shape[-2] // z.shape[-2]
        if factor > 1:
            h = F.avg_pool2d(h, factor)
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            h = conv(h)
            if i != last:
                h = F.relu(h)
        gamma = torch.softmax(h, dim=1)  # (B, K, H, W)
        sigma = torch.exp(self.log_sigma)

        # Per-pixel, per-class diagonal Gaussian log density of z.
        z_e = z[:, None]  # (B, 1, Cz, H, W)
        mu = self.mu[None, :, :, None, None]  # (1, K, C, 1, 1)
        log_n = -0.5 * (
            ((z_e - mu) / sigma[None, :, :, None, None]) ** 2
            + 2.0 * self.log_sigma[None, :, :, None, None]
            + _LOG_2PI
        ).sum(2)  # (B, K, H, W)
        log_mix = torch.logsumexp(log_n + torch.log(gamma + 1e-12), dim=1)
        logpz = log_mix.sum(dim=(-2, -1))  # (B,)
        return logpz, (self.mu, sigma, gamma)


def upsample_gamma(gamma, h: int, w: int):
    """Nearest-neighbour upsample of latent-grid responsibilities (B, K, Hz,
    Wz) back to the image grid, for per-pixel colour statistics and
    recolouring."""
    fh = h // gamma.shape[-2]
    fw = w // gamma.shape[-1]
    if fh > 1:
        gamma = gamma.repeat_interleave(fh, dim=-2)
    if fw > 1:
        gamma = gamma.repeat_interleave(fw, dim=-1)
    return gamma


def bits_per_dim(logpz, delta_logp, image_shape, nvals: int = 256,
                 logpu: float = 0.0):
    """The training objective of ``compute_loss`` (``train_img_horo.py:
    466-501``): ``logpx = logpz - delta_logp - log(nvals)*dims - logpu``,
    reported as bits/dim; ``dims`` is the product of ``image_shape``. The
    constants are rounded in float32, as the JAX package computes them."""
    dims = int(np.prod(image_shape))
    log_nvals = float(np.log(np.float32(nvals)) * np.float32(dims))
    logpx = logpz - delta_logp - log_nvals - logpu
    return -logpx / float(np.float32(dims) * np.log(np.float32(2.0)))
