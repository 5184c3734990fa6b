"""The flow + GMM colour model's deploy recolour: the program under test
and its plain reference, as the harness drives them.

The program is ``stainlib_tpu_torch``'s batch entry
``normalization.flow.FlowNormalizer``, built from the configuration's
widths and the weights ``benchmark/flow_weights.py`` draws: ``fit`` on
the target tile, ``fit_source`` on the mosaic's tiles (the semantics of
``normalization/slide.flow_normalize_slide``: one slide-level map for
every tile), then ``transform`` per batch. A batch's results are its
recoloured tiles, which the harness compares on the sampled batches, and
the flow's latent of it (the entry's ``latent``), which the recolour's
bytes do not read (``reference/flow.py``). The harness compares a batch's
tiles alone, so the latent is held to the reference in set-up: the
entry's own ``transform`` of one batch of the cell's size cut from the
mosaic's tiles gives the fit ``mosaic_z``. The other fits are the
template's and the slide's per-class (mu, sigma).

The reference recomputes every value from the same target tile, mosaic
and drawn weights (``benchmark/reference/flow.py``) and takes nothing the
program made. A commit without the entry fails at once with an
``ImportError``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from benchmark import flow_weights
from benchmark.reference import flow as ref
from benchmark.reference import planar as ref_planar

TISSUE_THRESHOLD = 0.8  # the tissue mask's luminosity threshold


class Program(NamedTuple):
    fits: dict  # name -> tensor: the set-up's fitted values
    call: Callable  # (batch, side, side, 3) uint8 -> the same, recoloured


def _weights(cfg: dict, target):
    return flow_weights.draw(cfg, flow_weights.seed_of(cfg, target),
                             target.device)


def _tiles(mosaic, side: int):
    """The mosaic's stacked tiles as a batch (n, side, side, 3)."""
    return mosaic.reshape(-1, side, side, 3)


def _batch_of(tiles, n: int):
    """A batch of ``n`` tiles, the mosaic's in turn."""
    return tiles[torch.arange(n, device=tiles.device) % tiles.shape[0]]


def _slide_only(traffic: dict) -> None:
    if traffic["estimation"] != "slide":
        raise ValueError("the flow method runs per-slide mixes: one source "
                         "statistic fitted in set-up on the mosaic")


def load(device) -> None:
    """Nothing to build: the model runs on torch's own convolutions."""


def program(cfg: dict, traffic: dict, target, mosaic) -> Program:
    """The port, fitted and ready: its fits and its batched entry."""
    from stainlib_tpu_torch.models.train_flow import FlowConfig
    from stainlib_tpu_torch.normalization.flow import FlowNormalizer

    _slide_only(traffic)
    params, spectral = _weights(cfg, target)
    fc = FlowConfig(image_size=cfg["image_size"], n_scales=cfg["n_scales"],
                    blocks_per_scale=cfg["blocks_per_scale"],
                    hidden=cfg["hidden"], coeff=cfg["coeff"],
                    n_clusters=cfg["n_clusters"],
                    kernel_sizes=tuple(cfg["kernel_sizes"]))
    norm = FlowNormalizer(fc, params, spectral, transfer=cfg["transfer"])
    tiles = _tiles(mosaic, target.shape[0])
    t = norm.fit(target[None])
    s = norm.fit_source(tiles)
    norm.transform(_batch_of(tiles, traffic["batch"]))
    fits = {"template_mu": t.mu, "template_sigma": t.sigma,
            "slide_mu": s.mu, "slide_sigma": s.sigma,
            "mosaic_z": norm.latent}
    return Program(fits, norm.transform)


def reference(cfg: dict, traffic: dict, target, mosaic,
              low=None) -> Program:
    """The plain reference in the program's place; ``low`` (a dtype) makes
    it the control."""
    _slide_only(traffic)
    weights = _weights(cfg, target)
    tiles = _tiles(mosaic, target.shape[0])
    tmpl = ref.stats(target[None], weights, cfg, low)
    src = ref.stats(tiles, weights, cfg, low)
    fits = {"template_mu": tmpl[0], "template_sigma": tmpl[1],
            "slide_mu": src[0], "slide_sigma": src[1],
            "mosaic_z": ref.latent(_batch_of(tiles, traffic["batch"]),
                                   weights, cfg, low)}
    return Program(fits, lambda b: ref.recolor(b, weights, cfg, src, tmpl,
                                               low))


def tissue_share(cfg: dict, batch) -> float:
    """The share of the batch's pixels in the tissue mask (information
    only: the model recolours every pixel)."""
    lut = ref_planar._tables(batch.device)
    x = batch.reshape(-1, 3).to(torch.long)
    mask = (lut[1][x[:, 0]] + lut[2][x[:, 1]] + lut[3][x[:, 2]]
            < ref_planar._y_threshold(TISSUE_THRESHOLD))
    return float(mask.to(torch.float32).mean())
