"""Layers shared by the port's classifier and segmenter nets, each with the
semantics of its flax counterpart.

* initializers: flax's ``lecun_normal`` (the default of ``nn.Conv``,
  ``nn.ConvTranspose`` and ``nn.Dense``) and ``glorot_uniform``, drawn
  from a ``torch.Generator``; biases start at zero;
* :class:`Dense`: a kernel in flax's (in, out) layout, ``x @ kernel + b``;
* :class:`Conv`: a convolution whose padding is flax's: ``"SAME"`` pads as
  TensorFlow does (at stride 2 on an even side, 0 before and 1 after),
  ``"VALID"`` not at all; weights (out, in / groups, kh, kw);
* :class:`BatchNorm`: flax's ``nn.BatchNorm`` (epsilon 1e-5). Training
  normalizes with the batch's mean and its biased variance, taken as
  E[x^2] - E[x]^2 (``use_fast_variance``), and gives back the running
  statistics moved by ``momentum`` (flax's decay: 0.99 keeps 99% of the
  old value; ``nn.BatchNorm2d`` would take 0.01 and the unbiased
  variance). Inference normalizes with the running statistics. There is
  no ``num_batches_tracked``;
* :func:`dropout`: inverted dropout with its keep mask drawn from a
  ``torch.Generator``.

Activations are NCHW inside the nets; the nets take and return NHWC as the
JAX package's do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled so that its variance is 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, generator=None):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
    return t


def glorot_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                    generator=None):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-limit, limit, generator=generator)
    return t


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` (in, out), ``bias`` (out,)."""

    def __init__(self, features_in: int, features: int, device=None,
                 generator=None):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(features_in, features, device=device), features_in,
            generator))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        return x @ self.kernel + self.bias


def _same_pads(size: int, k: int, s: int) -> tuple:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` on NCHW: ``padding`` "SAME" (TensorFlow's, which is
    asymmetric where the total is odd) or "VALID"; ``groups`` is flax's
    ``feature_group_count``. ``init`` is "lecun" (flax's default) or
    "glorot"."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 padding: str = "SAME", groups: int = 1, bias: bool = True,
                 init: str = "lecun", device=None, generator=None):
        super().__init__()
        self.k, self.stride, self.padding = k, stride, padding
        self.groups = groups
        w = torch.empty(c_out, c_in // groups, k, k, device=device)
        fan_in = (c_in // groups) * k * k
        if init == "glorot":
            glorot_uniform_(w, fan_in, c_out * k * k, generator)
        else:
            lecun_normal_(w, fan_in, generator)
        self.weight = nn.Parameter(w)
        self.bias = (nn.Parameter(torch.zeros(c_out, device=device)) if bias
                     else None)

    def forward(self, x):
        if self.padding == "SAME":
            (t, b), (l, r) = (_same_pads(x.shape[-2], self.k, self.stride),
                              _same_pads(x.shape[-1], self.k, self.stride))
            if t == b and l == r:
                return F.conv2d(x, self.weight, self.bias, self.stride,
                                (t, l), 1, self.groups)
            x = F.pad(x, (l, r, t, b))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, 1,
                        self.groups)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of NCHW, or of (B, C).

    ``scale`` and ``bias`` are parameters; ``mean`` and ``var`` buffers
    (flax's ``batch_stats``). ``forward(x, train, stats)``: in training
    the moved running statistics go, detached, into the dict ``stats``
    under the buffers' names in the top-level net (``path``, set by
    :func:`name_batch_norms`); the buffers themselves are not written."""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum, self.eps, self.path = momentum, eps, ""
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x, train: bool, stats: dict | None = None):
        dims = (0,) if x.dim() == 2 else (0, 2, 3)
        shape = (1, -1) if x.dim() == 2 else (1, -1, 1, 1)
        if train:
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            if stats is not None:
                m = self.momentum
                stats[f"{self.path}.mean"] = (
                    m * self.mean + (1.0 - m) * mean).detach()
                stats[f"{self.path}.var"] = (
                    m * self.var + (1.0 - m) * var).detach()
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (x - mean.reshape(shape)) * mul.reshape(shape)
        return y + self.bias.reshape(shape)


def dropout(x, rate: float, train: bool, generator=None):
    """flax ``nn.Dropout``: in training keep each value with probability
    ``1 - rate`` and divide the kept by it; the mask's uniforms come from
    ``generator`` (on ``x``'s device). Outside training, or at rate 0, the
    identity."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def name_batch_norms(net: nn.Module) -> None:
    """Give each BatchNorm of ``net`` its name in ``net``, under which its
    moved statistics are returned."""
    for name, m in net.named_modules():
        if isinstance(m, BatchNorm):
            m.path = name
