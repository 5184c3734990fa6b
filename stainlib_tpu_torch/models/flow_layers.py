"""Invertible flow layers: ActNorm, logit transform, squeeze, Lipschitz nets.

Port of the JAX package's ``models/flow_layers.py``, the building blocks of
the residual-flow colour model (the reference's ``lib/`` layers, called at
``dlmodels/color-information/train_img_horo.py:289,321,324-358,1089-1095``).
Tensors are NCHW. The spectral-norm power iteration runs a fixed number of
steps, and its state (``u``, ``sigma``) lives in buffers that only
:func:`power_iteration` recomputes, after each optimizer step
(``resflow.update_lipschitz``), never inside a forward pass.

The convolutions are ``torch.nn.functional.conv2d`` / ``conv_transpose2d``
(cuDNN on the card, float32: the package turns TF32 off at import).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _normal_(t, std, generator):
    with torch.no_grad():
        return t.normal_(0.0, std, generator=generator)


class ActNorm(nn.Module):
    """Per-channel affine with data-dependent init.

    y = (x - b) * exp(logs); logdet = sum(logs) * H * W. A forward with
    ``data_init=True`` first sets b and logs from the batch (the mean, and
    ``-log(std + 1e-6)``), as the JAX package's ``init`` does (the
    reference's lazy ActNorm materialized by a dummy forward at resume,
    ``train_img_horo.py:437-441``).
    """

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.logs = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x, data_init: bool = False):
        if data_init:
            with torch.no_grad():
                self.bias.copy_(x.mean(dim=(0, 2, 3)))
                std = x.std(dim=(0, 2, 3), correction=0) + 1e-6
                self.logs.copy_(-torch.log(std))
        logdet = self.logs.sum() * (x.shape[-2] * x.shape[-1])
        return ((x - self.bias[:, None, None])
                * torch.exp(self.logs)[:, None, None], logdet)

    def inverse(self, y):
        logdet = self.logs.sum() * (y.shape[-2] * y.shape[-1])
        return (y * torch.exp(-self.logs)[:, None, None]
                + self.bias[:, None, None], -logdet)


class LogitTransform(nn.Module):
    """[0,1] images -> logit space (init layer, ``train_img_horo.py:289``).

    y = logit(a + (1 - 2a) x); the per-pixel logdet summed over the image.
    """

    def __init__(self, alpha: float = 1e-5):
        super().__init__()
        self.alpha = alpha
        # log(1 - 2a) rounded as the JAX package computes it, in float32.
        self._log_scale = float(np.log(np.float32(1.0 - 2.0 * alpha)))

    def forward(self, x):
        a = self.alpha
        s = a + (1.0 - 2.0 * a) * x
        y = torch.log(s) - torch.log1p(-s)
        logdet = (self._log_scale - torch.log(s)
                  - torch.log1p(-s)).sum(dim=(-3, -2, -1))
        return y, logdet

    def inverse(self, y):
        a = self.alpha
        s = torch.sigmoid(y)
        x = (s - a) / (1.0 - 2.0 * a)
        # dx/dy = s(1-s)/(1-2a): the negation of forward's logdet.
        logdet = (torch.log(s) + torch.log1p(-s)
                  - self._log_scale).sum(dim=(-3, -2, -1))
        return x, logdet


def squeeze(x):
    """Space-to-depth x2 (``SqueezeLayer``, ``train_img_horo.py:321``) in
    the JAX package's channel order: input channel ``c`` of sub-pixel
    ``(dy, dx)`` lands on channel ``(2 dy + dx) C + c`` (``pixel_unshuffle``
    would put it on ``4 c + 2 dy + dx``)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)


def unsqueeze(x):
    b, c, h, w = x.shape
    x = x.reshape(b, 2, 2, c // 4, h, w)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(b, c // 4, 2 * h, 2 * w)


def power_iteration(weight, u, n_iters: int = 1):
    """``n_iters`` fixed steps of power iteration on the conv operator of
    ``weight`` (OIHW, SAME padding) from ``u``: returns the new ``u`` and
    the operator-norm estimate ``sigma``. The adjoint of the conv is
    ``conv_transpose2d`` with the same weight and padding (the JAX
    package's conv with the kernel flipped and its in/out axes swapped)."""
    pad = weight.shape[-1] // 2
    with torch.no_grad():
        for _ in range(n_iters):
            v = F.conv2d(u, weight, padding=pad)
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u = F.conv_transpose2d(v, weight, padding=pad)
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
        sigma = torch.linalg.vector_norm(F.conv2d(u, weight, padding=pad))
    return u, sigma


class SpectralNormConv(nn.Module):
    """Conv whose operator norm is held to ``coeff``.

    The kernel is scaled by ``min(1, coeff / sigma)``, a constant to
    autograd, where ``sigma`` is the buffer that :func:`power_iteration`
    refreshes after each optimizer step (``update_lipschitz``,
    ``train_img_horo.py:1089-1095``). ``sigma`` starts at 1, so before the
    first refresh the factor is ``min(1, coeff)``; ``u`` starts as a normal
    draw of the layer's input shape ``(1, C, H, W)``.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 coeff: float = 0.98, n_iters: int = 1,
                 input_hw: Sequence[int] = (1, 1), device=None,
                 generator=None):
        super().__init__()
        self.coeff = coeff
        self.n_iters = n_iters
        k = kernel_size
        # variance_scaling(1, "fan_in", "normal"): std sqrt(1 / (k k C_in)).
        self.weight = nn.Parameter(_normal_(
            torch.empty(features, in_channels, k, k, device=device),
            math.sqrt(1.0 / (k * k * in_channels)), generator))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        h, w = input_hw
        self.register_buffer("u", _normal_(
            torch.empty(1, in_channels, h, w, device=device), 1.0, generator))
        self.register_buffer("sigma", torch.ones((), device=device))

    def scaled_weight(self):
        factor = torch.clamp_max(self.coeff / (self.sigma + 1e-12), 1.0)
        return self.weight * factor.detach()

    def forward(self, x):
        return F.conv2d(x, self.scaled_weight(), self.bias,
                        padding=self.weight.shape[-1] // 2)


def _act(v):
    # swish's slope is bounded by ~1.0998, so swish / 1.1 is 1-Lipschitz.
    return F.silu(v) / 1.1


def lipschitz_apply(x, weights):
    """The residual branch on explicit ``[(weight, bias), ...]``: a pure
    function of its arguments, so a checkpointed caller recomputes it from
    what it was given."""
    y = x
    last = len(weights) - 1
    for i, (w, b) in enumerate(weights):
        y = F.conv2d(y, w, b, padding=w.shape[-1] // 2)
        if i != last:
            y = _act(y)
    return y


class LipschitzNet(nn.Module):
    """The residual branch g(x): spectral-norm convs + ``swish / 1.1``.

    ``kernel_sizes`` sets each layer's kernel: the reference's
    ``--kernels`` flag, default '3-1-3' in its published ~500k-parameter
    model (``train_img_horo.py:110``).
    """

    def __init__(self, channels: int, hidden: int = 64, n_layers: int = 3,
                 coeff: float = 0.98, input_hw: Sequence[int] = (1, 1),
                 kernel_sizes: Sequence[int] = (3, 3, 3), device=None,
                 generator=None):
        super().__init__()
        ins = [channels] + [hidden] * (n_layers - 1)
        self.convs = nn.ModuleList(
            SpectralNormConv(
                c_in, channels if i == n_layers - 1 else hidden,
                kernel_size=kernel_sizes[i % len(kernel_sizes)], coeff=coeff,
                input_hw=input_hw, device=device, generator=generator)
            for i, c_in in enumerate(ins))

    def weights(self):
        """The scaled kernels and biases, as :func:`lipschitz_apply` takes
        them."""
        return [(c.scaled_weight(), c.bias) for c in self.convs]

    def forward(self, x):
        return lipschitz_apply(x, self.weights())
