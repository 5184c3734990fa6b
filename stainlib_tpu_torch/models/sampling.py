"""Qualitative sampling from trained flows.

Port of the JAX package's ``models/sampling.py``, the counterpart of
``dlmodels/color-information/qualitative_samples.py:60-200``: draw
latents from the prior (a standard normal or the GMM mixture), invert the
flow, save an image grid. Tensors are NCHW; the latent is (n, C f^2,
H / f, W / f) with the squeeze's channel order, which is the JAX
package's NHWC channel order.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from stainlib_tpu_torch.models.resflow import ResidualFlow


class _Inverse(nn.Module):
    """``flow.inverse`` as a module's forward, so that
    ``functional_call`` can run it with given weights."""

    def __init__(self, flow: ResidualFlow):
        super().__init__()
        self.flow = flow

    def forward(self, z):
        return self.flow.inverse(z)


@torch.no_grad()
def flow_inverse(flow: ResidualFlow, variables, z):
    """``flow.inverse(z)`` with ``variables`` (the flow's parameters and
    spectral buffers by name, ``{**params["flow"], **spectral}``) in place
    of the module's own."""
    return functional_call(_Inverse(flow),
                           {f"flow.{k}": v for k, v in variables.items()},
                           (z,))


def _sample_flow_apply(flow: ResidualFlow, variables, z, comp=None,
                       gmm_params: Optional[dict] = None,
                       temperature: float = 1.0):
    """:func:`sample_flow` from its draws: ``z`` (n, C', H', W') standard
    normal, ``comp`` (n, H', W') mixture classes (with ``gmm_params``)."""
    z = z * temperature
    if gmm_params is not None:
        mu = torch.as_tensor(gmm_params["mu"], device=z.device)  # (K, C)
        sigma = torch.as_tensor(gmm_params["sigma"], device=z.device)
        # Each class's mean and scale, averaged over the GMM's channels,
        # broadcast over the latent's channels.
        scale = sigma[comp].mean(-1)[:, None]
        shift = mu[comp].mean(-1)[:, None]
        z = z * scale + shift
    return torch.clamp(flow_inverse(flow, variables, z), 0.0, 1.0)


def sample_flow(flow: ResidualFlow, variables, n: int, generator=None,
                gmm_params: Optional[dict] = None,
                temperature: float = 1.0):
    """Draw ``n`` samples: z ~ prior -> x = flow^{-1}(z), in [0, 1],
    (n, C, H, W) for the flow's ``input_shape``.

    ``variables``: the flow's parameters and spectral buffers by name (see
    :func:`flow_inverse`). ``generator``: a ``torch.Generator`` on the
    device to sample on (the flow's). With ``gmm_params`` (mu (K, C),
    sigma (K, C), optional pi (K,)), the latents come from the mixture:
    one class per latent pixel, drawn with probabilities ``pi``, its mean
    and scale shared by every channel of that pixel."""
    dev = generator.device if generator is not None else next(
        flow.parameters()).device
    shape = flow.latent_shape(n)
    z = torch.randn(shape, generator=generator, device=dev)
    comp = None
    if gmm_params is not None:
        mu = torch.as_tensor(gmm_params["mu"], device=dev)
        pi = gmm_params.get("pi")
        pi = (torch.ones(mu.shape[0], device=dev) if pi is None
              else torch.as_tensor(pi, dtype=torch.float32, device=dev))
        comp = torch.multinomial(pi / pi.sum(), n * shape[2] * shape[3],
                                 replacement=True,
                                 generator=generator).reshape(
            n, shape[2], shape[3])
    return _sample_flow_apply(flow, variables, z, comp, gmm_params,
                              temperature)


def save_sample_grid(path: str, samples, cols: int = 8):
    """Tile (N, C, H, W) samples in [0, 1] into one PNG grid."""
    from PIL import Image

    arr = torch.as_tensor(samples).detach().cpu().permute(0, 2, 3, 1).numpy()
    n, h, w, c = arr.shape
    cols = min(cols, n)
    rows = (n + cols - 1) // cols
    grid = np.ones((rows * h, cols * w, 3), np.uint8) * 255
    for i in range(n):
        r, col = divmod(i, cols)
        img = (arr[i] * 255).astype(np.uint8)
        if c == 1:
            img = np.repeat(img, 3, axis=-1)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = img
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(grid).save(path)
    return path
