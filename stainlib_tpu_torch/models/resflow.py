"""Residual flow: invertible ResNet blocks with a tractable log-determinant.

Port of the JAX package's ``models/resflow.py`` (the colour model's
``lib.resflow.ResidualFlow``, constructed at ``train_img_horo.py:324-358``).
Structure: LogitTransform -> per scale [ActNorm -> iResBlock] x k, with a
squeeze between scales. Tensors are NCHW.

The log-determinant of each block is the Hutchinson power series with a
fixed truncation, ``sum_{k=1..n} (-1)^{k+1}/k v0^T J^k v0``, with
Rademacher probes ``v0``. ``J^k v0`` comes from a chain of
``torch.func.jvp`` calls, as the JAX package chains ``jax.jvp``; autograd
differentiates through the chain to the parameters, also under
``torch.utils.checkpoint(use_reentrant=False)`` (one checkpoint per series
term with ``remat_logdet``). ``torch.func.grad`` does not compose with
those checkpoints, so the trainer calls autograd itself. The probes are
drawn from a ``torch.Generator`` in block order, or given explicitly, one
tensor per block.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from stainlib_tpu_torch.kernels import flow_branch
from stainlib_tpu_torch.models.flow_layers import (
    ActNorm,
    LipschitzNet,
    LogitTransform,
    SpectralNormConv,
    lipschitz_apply,
    power_iteration,
    squeeze,
    unsqueeze,
)


def rademacher(shape, generator=None, device=None, dtype=torch.float32):
    """A tensor of independent +-1 draws."""
    bits = torch.randint(0, 2, tuple(shape), generator=generator,
                         device=device)
    return (2 * bits - 1).to(dtype)


class IResBlock(nn.Module):
    """y = x + g(x) with contractive g; Hutchinson power-series logdet."""

    def __init__(self, channels: int, hidden: int = 64, n_layers: int = 3,
                 coeff: float = 0.98, n_power_series: int = 6,
                 n_probes: int = 1, n_fixed_point_iters: int = 40,
                 input_hw: Sequence[int] = (1, 1),
                 kernel_sizes: Sequence[int] = (3, 3, 3),
                 remat_logdet: bool = False, device=None, generator=None):
        super().__init__()
        self.n_power_series = n_power_series
        self.n_probes = n_probes
        self.n_fixed_point_iters = n_fixed_point_iters
        self.remat_logdet = remat_logdet
        # Whether the last forward computed x + g(x) with the branch kernels.
        self.fused = False
        self.g = LipschitzNet(channels, hidden=hidden, n_layers=n_layers,
                              coeff=coeff, input_hw=input_hw,
                              kernel_sizes=kernel_sizes, device=device,
                              generator=generator)

    def forward(self, x, probe=None, generator=None,
                exact_logdet: bool = False, skip_logdet: bool = False):
        """``probe``: (n_probes, *x.shape) Rademacher draws; drawn from
        ``generator`` when None. With ``skip_logdet``, autograd off and a
        CUDA input of the shapes ``kernels.flow_branch`` is written for
        (the deploy encode), ``x + g(x)`` is its kernels'."""
        weights = self.g.weights()
        self.fused = skip_logdet and flow_branch.eligible(x, weights)
        if self.fused:
            y = flow_branch.flow_branch(x, weights)
        else:
            y = x + lipschitz_apply(x, weights)
        if skip_logdet:
            return y, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        if exact_logdet:
            return y, _exact_logdet(lambda v: lipschitz_apply(v, weights), x)
        if probe is None:
            probe = rademacher((self.n_probes,) + tuple(x.shape), generator,
                               x.device, x.dtype)
        logdet = torch.stack([
            _power_series_logdet(weights, x, v0, self.n_power_series,
                                 self.remat_logdet)
            for v0 in probe]).mean(0)
        return y, logdet

    def inverse(self, y):
        """Fixed-point iteration x <- y - g(x), a fixed count of steps; it
        converges geometrically for contractive g (Banach)."""
        weights = self.g.weights()
        x = y
        for _ in range(self.n_fixed_point_iters):
            x = y - lipschitz_apply(x, weights)
        return x


def _series_term(x, vk, *flat):
    """J_g(x) vk for g = lipschitz_apply with the (weight, bias) pairs
    ``flat``: every tensor it reads is an argument, so a checkpoint
    recomputes it from the same tensors."""
    weights = list(zip(flat[::2], flat[1::2]))
    return torch.func.jvp(lambda v: lipschitz_apply(v, weights), (x,),
                          (vk,))[1]


def _power_series_logdet(weights, x, v0, n_terms: int, remat: bool = False):
    """log det(I + J_g) ~ sum_k (-1)^{k+1}/k v0^T J_g^k v0 for one probe
    ``v0``, fixed truncation, jvp-chained.

    ``remat=True`` checkpoints each term: its conv intermediates are
    recomputed in the backward pass instead of being saved per term (the
    role of the reference's ``--mem-eff`` flags, ``train_img_horo.py:
    91-98``), which the 256^2 reference-capacity model needs to fit."""
    flat = [t for wb in weights for t in wb]
    vk = v0
    acc = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for k in range(1, n_terms + 1):
        if remat:
            jv = checkpoint(_series_term, x, vk, *flat, use_reentrant=False)
        else:
            jv = _series_term(x, vk, *flat)
        coeff = (1.0 if k % 2 == 1 else -1.0) / k
        acc = acc + coeff * (jv * v0).reshape(x.shape[0], -1).sum(-1)
        vk = jv
    return acc


def _exact_logdet(g_fn, x):
    """Brute-force log|det(I + J_g)| per sample (test-scale inputs only)."""
    out = []
    for xi in x:
        def f(v):
            return g_fn(v.reshape((1,) + xi.shape))[0].reshape(-1)

        J = torch.func.jacfwd(f)(xi.reshape(-1))
        eye = torch.eye(J.shape[0], dtype=J.dtype, device=J.device)
        out.append(torch.linalg.slogdet(eye + J)[1])
    return torch.stack(out)


class ResidualFlow(nn.Module):
    """Multi-scale residual flow over NCHW images in [0, 1].

    forward: x -> (z, delta_logp) with delta_logp = -sum logdet (the sign
    convention of ``compute_loss``: ``logpx = logpz - delta_logp - ...``,
    ``train_img_horo.py:466-501``). ``input_shape`` is (C, H, W), kept as
    an attribute (the JAX module's is (H, W, C)); the latent of an input
    of that shape is :meth:`latent_shape`.
    """

    def __init__(self, n_scales: int = 2, blocks_per_scale: int = 4,
                 hidden: int = 64, coeff: float = 0.98,
                 n_power_series: int = 6,
                 input_shape: Sequence[int] = (1, 32, 32),
                 squeeze_first: bool = False, logit_alpha: float = 1e-5,
                 kernel_sizes: Sequence[int] = (3, 3, 3),
                 remat_logdet: bool = False, device=None, generator=None):
        super().__init__()
        self.n_scales = n_scales
        self.blocks_per_scale = blocks_per_scale
        self.squeeze_first = squeeze_first
        self.input_shape = tuple(input_shape)
        self.init_layer = LogitTransform(alpha=logit_alpha)
        c, h, w = input_shape
        if squeeze_first:
            c, h, w = c * 4, h // 2, w // 2
        scales, norms = [], []
        for s in range(n_scales):
            blocks = []
            for _ in range(blocks_per_scale):
                blocks.append(IResBlock(
                    c, hidden=hidden, coeff=coeff,
                    n_power_series=n_power_series, input_hw=(h, w),
                    kernel_sizes=kernel_sizes, remat_logdet=remat_logdet,
                    device=device, generator=generator))
            scales.append(nn.ModuleList(blocks))
            norms.append(nn.ModuleList(
                ActNorm(c, device=device) for _ in range(blocks_per_scale)))
            if s != n_scales - 1:
                c, h, w = c * 4, h // 2, w // 2
        self.scales = nn.ModuleList(scales)
        self.norms = nn.ModuleList(norms)

    def latent_shape(self, n: int = 1) -> tuple:
        """The latent's shape (n, C', H', W') for ``n`` inputs of
        ``input_shape``: the last block's input, after every squeeze."""
        return self.probe_shapes((n, *self.input_shape))[-1]

    def probe_shapes(self, x_shape) -> list:
        """The input shape of each block, in block order, for an input of
        ``x_shape`` (B, C, H, W)."""
        b, c, h, w = x_shape
        if self.squeeze_first:
            c, h, w = c * 4, h // 2, w // 2
        shapes = []
        for s in range(self.n_scales):
            shapes += [(b, c, h, w)] * self.blocks_per_scale
            c, h, w = c * 4, h // 2, w // 2
        return shapes

    def draw_probes(self, x_shape, generator=None, device=None) -> list:
        """One (n_probes, *shape) Rademacher tensor per block, in block
        order: the draws ``forward`` makes from ``generator`` when given no
        probes."""
        blocks = [blk for scale in self.scales for blk in scale]
        return [rademacher((blk.n_probes,) + tuple(s), generator, device)
                for blk, s in zip(blocks, self.probe_shapes(x_shape))]

    def forward(self, x, probes: Optional[Sequence] = None, generator=None,
                exact_logdet: bool = False, skip_logdet: bool = False,
                data_init: bool = False):
        """``probes``: one (n_probes, B, C, H, W) tensor per block (see
        :meth:`draw_probes`), or None to draw them from ``generator``.
        ``data_init`` sets each ActNorm from the batch that reaches it."""
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        y, ld = self.init_layer(x)
        logdet = logdet + ld
        if self.squeeze_first:
            y = squeeze(y)
        i = 0
        for s in range(self.n_scales):
            for b in range(self.blocks_per_scale):
                y, ld = self.norms[s][b](y, data_init=data_init)
                logdet = logdet + ld
                y, ld = self.scales[s][b](
                    y, probe=None if probes is None else probes[i],
                    generator=generator, exact_logdet=exact_logdet,
                    skip_logdet=skip_logdet)
                logdet = logdet + ld
                i += 1
            if s != self.n_scales - 1:
                y = squeeze(y)
        return y, -logdet  # delta_logp convention

    def inverse(self, z):
        y = z
        for s in reversed(range(self.n_scales)):
            if s != self.n_scales - 1:
                y = unsqueeze(y)
            for b in reversed(range(self.blocks_per_scale)):
                y = self.scales[s][b].inverse(y)
                y, _ = self.norms[s][b].inverse(y)
        if self.squeeze_first:
            y = unsqueeze(y)
        y, _ = self.init_layer.inverse(y)
        return y


def update_lipschitz(flow: ResidualFlow, params: dict, spectral: dict) -> dict:
    """Re-run the power iteration of every spectral-norm conv (the
    reference's post-step ``update_lipschitz(model)``,
    ``train_img_horo.py:1089-1095``) with the kernels in ``params`` from
    the ``u`` in ``spectral`` (flat dicts named as ``flow``'s parameters and
    buffers). Returns the new spectral dict; nothing is changed in place.

    The JAX package runs a forward pass on one batch element to reach the
    same update (flax writes variables only inside ``apply``); the power
    iteration reads only the kernels and ``u``, so no data is needed."""
    new = dict(spectral)
    for name, mod in flow.named_modules():
        if isinstance(mod, SpectralNormConv):
            u, sigma = power_iteration(params[f"{name}.weight"],
                                       spectral[f"{name}.u"], mod.n_iters)
            new[f"{name}.u"], new[f"{name}.sigma"] = u, sigma
    return new
