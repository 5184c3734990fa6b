"""Random weights of the flow + GMM colour model, drawn from a seed: the
data the ``flow`` method hands to the program and to the reference alike.

The repository holds no trained checkpoint, so the weights are drawn, in
float32 on the CPU (the same bits wherever the run goes) and then moved to
the device:

* each spectral-norm kernel from a normal of variance ``1 / (k^2 Cin)``,
  as the port initializes it, its bias from a normal of 0.01;
* each kernel's ``sigma`` by its own power iteration (:data:`POWER_ITERS`
  steps on a grid of at most :data:`POWER_GRID` squared, SAME padding), so
  that every residual branch is held to ``coeff`` as after the port's
  ``update_lipschitz``; ``u`` is the iteration's last vector;
* ActNorm's bias and log-scale from a normal of 0.1, so that it is not the
  identity;
* the GMM head's kernels from a normal truncated at two deviations with
  variance ``1 / (9 Cin)`` (the port's), its biases from a normal of 0.05,
  the class means evenly over [-1, 1] and the log-scales 0.

The names are those of ``stainlib_tpu_torch.models.train_flow.
build_models``: ``params = {"flow": {...}, "gmm": {...}}`` and the flow's
buffers ``spectral``. Nothing of the port is imported.
"""

from __future__ import annotations

import hashlib
import math

import torch
import torch.nn.functional as F

POWER_ITERS = 10
POWER_GRID = 16
GMM_HIDDEN = 32  # the port's ConvGMM: 2 -> 32 -> 32 -> K, 3x3
_TRUNC_STD = 0.87962566103423978  # a unit normal's std truncated at 2


def seed_of(cfg: dict, target) -> int:
    """The weights' seed: the configuration's ``weights_seed`` mixed with
    the bytes of the run's target tile, which the run's ``--seed`` draws."""
    digest = hashlib.sha256(target.cpu().numpy().tobytes()).digest()
    return (cfg["weights_seed"] ^ int.from_bytes(digest[:8], "little")) \
        % (2 ** 63)


def _power_sigma(w, grid: int, g: torch.Generator):
    """The operator norm of the SAME-padded convolution with kernel ``w``
    on a ``grid`` x ``grid`` input, by power iteration: (u, sigma)."""
    pad = w.shape[-1] // 2
    u = torch.randn((1, w.shape[1], grid, grid), generator=g)
    for _ in range(POWER_ITERS):
        v = F.conv2d(u, w, padding=pad)
        v = v / torch.linalg.vector_norm(v)
        u = F.conv_transpose2d(v, w, padding=pad)
        u = u / torch.linalg.vector_norm(u)
    return u, torch.linalg.vector_norm(F.conv2d(u, w, padding=pad))


def draw(cfg: dict, seed: int, device):
    """(params, spectral) of the configuration ``cfg`` (its
    ``image_size``, ``n_scales``, ``blocks_per_scale``, ``hidden``,
    ``kernel_sizes`` and ``n_clusters``), drawn from ``seed``, on
    ``device``."""
    g = torch.Generator().manual_seed(seed)
    ks = cfg["kernel_sizes"]
    hidden = cfg["hidden"]
    flow, spectral = {}, {}
    c, side = 1, cfg["image_size"]
    for s in range(cfg["n_scales"]):
        for b in range(cfg["blocks_per_scale"]):
            ins, outs = [c, hidden, hidden], [hidden, hidden, c]
            for i, (ci, co) in enumerate(zip(ins, outs)):
                k = ks[i % len(ks)]
                name = f"scales.{s}.{b}.g.convs.{i}"
                w = torch.randn((co, ci, k, k), generator=g) \
                    * math.sqrt(1.0 / (k * k * ci))
                flow[name + ".weight"] = w
                flow[name + ".bias"] = 0.01 * torch.randn(co, generator=g)
                u, sigma = _power_sigma(w, min(side, POWER_GRID), g)
                spectral[name + ".u"], spectral[name + ".sigma"] = u, sigma
            flow[f"norms.{s}.{b}.bias"] = 0.1 * torch.randn(c, generator=g)
            flow[f"norms.{s}.{b}.logs"] = 0.1 * torch.randn(c, generator=g)
        c, side = 4 * c, side // 2
    gmm = {}
    k_out = cfg["n_clusters"]
    for i, (ci, co) in enumerate(zip([2, GMM_HIDDEN, GMM_HIDDEN],
                                     [GMM_HIDDEN, GMM_HIDDEN, k_out])):
        std = math.sqrt(1.0 / (9 * ci)) / _TRUNC_STD
        w = torch.empty((co, ci, 3, 3))
        torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=g)
        gmm[f"convs.{i}.weight"] = w
        gmm[f"convs.{i}.bias"] = 0.05 * torch.randn(co, generator=g)
    gmm["mu"] = torch.linspace(-1.0, 1.0, k_out)[:, None].contiguous()
    gmm["log_sigma"] = torch.zeros((k_out, 1))

    def moved(d):
        return {n: t.to(device) for n, t in d.items()}

    return {"flow": moved(flow), "gmm": moved(gmm)}, moved(spectral)
