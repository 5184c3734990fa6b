"""Toy 2-D residual flows: density fitting on synthetic distributions.

Port of the JAX package's ``models/toy.py``, the counterpart of
``dlmodels/color-information/train_toy.py:31-60+``: an invertible-ResNet
flow on 2-D toy densities (rings, moons, a ring of Gaussians) with the
exact log-determinant (cheap at D = 2). Dense Lipschitz blocks instead of
convolutions; the same contraction and fixed-point inverse as the image
flow.

Layout: a dense layer's ``kernel`` is (in, out), flax's layout, so JAX
weights carry over by name (``convert.toy_state_from_jax``). The
power-iteration state ``u`` and the norm estimate ``sigma`` are buffers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stainlib_tpu_torch.api import _device
from stainlib_tpu_torch.ops.fdiv import fdiv

# ---------------------------------------------------------------------------
# Toy densities (the reference's toy_data generators)
# ---------------------------------------------------------------------------


def sample_toy(name: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if name == "8gaussians":
        centers = np.array(
            [(np.cos(t), np.sin(t)) for t in np.linspace(0, 2 * np.pi, 9)[:-1]]
        ) * 2.0
        idx = rng.integers(0, 8, n)
        return (centers[idx] + 0.2 * rng.standard_normal((n, 2))).astype(
            np.float32
        )
    if name == "rings":
        r = np.where(rng.random(n) < 0.5, 1.0, 2.0)
        t = rng.random(n) * 2 * np.pi
        pts = np.stack([r * np.cos(t), r * np.sin(t)], -1)
        return (pts + 0.05 * rng.standard_normal((n, 2))).astype(np.float32)
    if name == "moons":
        t = rng.random(n) * np.pi
        top = np.stack([np.cos(t), np.sin(t)], -1)
        bot = np.stack([1 - np.cos(t), -np.sin(t) + 0.5], -1)
        pts = np.where(rng.random((n, 1)) < 0.5, top, bot)
        return (pts + 0.08 * rng.standard_normal((n, 2))).astype(np.float32)
    raise ValueError(name)


# ---------------------------------------------------------------------------
# Dense Lipschitz residual flow
# ---------------------------------------------------------------------------


class SpectralDense(nn.Module):
    """Dense layer whose operator norm is held to ``coeff``: the kernel is
    scaled by ``min(1, coeff / sigma)``, a constant to autograd, with
    ``sigma`` the power iteration's estimate (starting at 1.0)."""

    def __init__(self, in_features: int, features: int, coeff: float = 0.97,
                 device=None, generator=None):
        super().__init__()
        self.coeff = coeff
        kernel = torch.randn((in_features, features), generator=generator,
                             device=device) / math.sqrt(in_features)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("u", torch.randn(
            (in_features,), generator=generator, device=device))
        self.register_buffer("sigma", torch.ones((), device=device))

    @torch.no_grad()
    def update_spectral(self):
        """Two power iterations from ``u``; writes the new ``u`` and
        ``sigma = |u W|`` in place (``toy.py:74-82``)."""
        w, u = self.kernel, self.u
        for _ in range(2):
            v = u @ w
            v = v / (torch.linalg.norm(v) + 1e-12)
            u = w @ v
            u = u / (torch.linalg.norm(u) + 1e-12)
        self.sigma.copy_(torch.linalg.norm(u @ w))
        self.u.copy_(u)

    def forward(self, x, update: bool = False):
        if update:
            self.update_spectral()
        # A tensor quotient: torch computes ``float / tensor`` as a
        # reciprocal times the float, which rounds otherwise.
        factor = torch.clamp(
            self.sigma.new_tensor(self.coeff) / (self.sigma + 1e-12), max=1.0)
        return x @ (self.kernel * factor.detach()) + self.bias


class ToyResBlock(nn.Module):
    """g(x) = d2(swish(d1(swish(d0(x)) / 1.1)) / 1.1), each layer
    Lipschitz-bounded."""

    def __init__(self, dim: int = 2, hidden: int = 64, coeff: float = 0.97,
                 device=None, generator=None):
        super().__init__()
        self.d0 = SpectralDense(dim, hidden, coeff, device, generator)
        self.d1 = SpectralDense(hidden, hidden, coeff, device, generator)
        self.d2 = SpectralDense(hidden, dim, coeff, device, generator)

    def forward(self, x, update: bool = False):
        g = fdiv(F.silu(self.d0(x, update)), 1.1)
        g = fdiv(F.silu(self.d1(g, update)), 1.1)
        return self.d2(g, update)


class ToyResFlow(nn.Module):
    """Stack of dense iResBlocks on R^2 with the exact log-determinant,
    the 2-D case where the reference also uses brute force."""

    def __init__(self, n_blocks: int = 6, hidden: int = 64,
                 coeff: float = 0.97, dim: int = 2, device=None,
                 generator=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            ToyResBlock(dim, hidden, coeff, device, generator)
            for _ in range(n_blocks))

    def update_spectral(self):
        """The power iterations of every layer (what ``forward(update=True)``
        runs first): the post-step Lipschitz refresh."""
        for mod in self.modules():
            if isinstance(mod, SpectralDense):
                mod.update_spectral()

    def forward(self, x, update: bool = False):
        """x -> (z, logdet). With ``update`` each layer refreshes ``u`` and
        ``sigma`` first (in place) and the pass uses the new ``sigma``.
        The logdet is exact: log|det(I + J_g)| per point, J_g by forward-mode
        differentiation (``toy.py:115-126``)."""
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        for block in self.blocks:
            y = x + block(x, update)

            def g(v, block=block):
                return block(v[None])[0]

            J = torch.func.vmap(torch.func.jacfwd(g))(x)
            logdet = logdet + torch.linalg.slogdet(eye + J)[1]
            x = y
        return x, logdet

    @torch.no_grad()
    def inverse(self, z, n_iters: int = 60):
        """Fixed-point inversion, ``n_iters`` steps per block from x = y."""
        for block in reversed(self.blocks):
            y = z
            x = y
            for _ in range(n_iters):
                x = y - block(x)
            z = x
        return z


@dataclasses.dataclass
class ToyConfig:
    dataset: str = "8gaussians"
    n_blocks: int = 6
    hidden: int = 64
    lr: float = 1e-3
    batch_size: int = 256
    n_iters: int = 500


_LOG_2PI = float(np.log(np.float32(2 * np.pi)))


def toy_nll(model: ToyResFlow, x):
    """Mean negative log-likelihood per point under the standard normal
    prior."""
    z, logdet = model(x)
    logpz = -0.5 * torch.sum(z * z, -1) - z.shape[-1] / 2 * _LOG_2PI
    return -torch.mean(logpz + logdet)


def train_toy(cfg: ToyConfig, seed: int = 0,
              log: Callable[[str], None] = print, device="cuda",
              model: Optional[ToyResFlow] = None):
    """Maximum-likelihood training on a toy density with Adam
    (``optax.adam(cfg.lr)``, ``models.train_flow.adam``), the Lipschitz
    refresh after each update. ``model``: the flow to train, as it is;
    default a new one with weights drawn from ``seed``. Returns (model,
    its state dict, the last step's nll per point)."""
    from stainlib_tpu_torch.models.train_flow import adam, apply_updates

    dev = _device(device)
    if model is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = ToyResFlow(n_blocks=cfg.n_blocks, hidden=cfg.hidden,
                           device=dev, generator=gen)
    data = torch.from_numpy(
        sample_toy(cfg.dataset, cfg.batch_size * 4, seed)).to(dev)
    names = [n for n, _ in model.named_parameters()]
    lr = float(np.float32(cfg.lr))
    tx = adam(lambda count: lr)
    opt_state = tx.init({n: p.detach() for n, p in model.named_parameters()})
    rng = np.random.default_rng(seed)
    loss = torch.tensor(float("inf"))
    for i in range(cfg.n_iters):
        idx = torch.from_numpy(rng.integers(0, len(data), cfg.batch_size))
        params = [p for _, p in model.named_parameters()]
        loss = toy_nll(model, data[idx.to(dev)])
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            updates, opt_state = tx.update(dict(zip(names, grads)),
                                           opt_state)
            new = apply_updates(dict(zip(names, params)), updates)
            for name, p in zip(names, params):
                p.copy_(new[name])
        model.update_spectral()
        loss = loss.detach()
        if i % 100 == 0:
            log(f"toy iter {i}: nll {float(loss):.4f}")
    return model, model.state_dict(), float(loss)
