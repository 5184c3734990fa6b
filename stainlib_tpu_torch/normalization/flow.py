"""The flow + GMM colour model's deploy recolour as a batch entry.

The deploy step of ``train_img_horo.py:658-930`` on batches of uint8 tiles
already on the device: the template's per-class HSD statistics under the
GMM responsibilities (``fit``), optionally one source statistic for a whole
slide (``fit_source``), then per batch the encode (RGB -> HSD, the flow's
forward with the log-determinant skipped, the GMM head, gamma upsampled to
the image grid: ``models.validate_flow.encode_latent``) and the per-class
transfer back to uint8 RGB (``models.validate_flow.transfer_batch``). The
results of a batch are its recoloured tiles and the flow's latent of it,
``latent`` (B, 4^(n-1), S / 2^(n-1), S / 2^(n-1)): the model's code of the
tiles, on which the GMM's density is defined; gamma, and so the colours,
read the chroma alone (``models.gmm.ConvGMM``).

Shaped like ``api.ExtractiveStainNormalizer``, but on batches and on the
tiles' device: it takes the weights as tensors (``params`` ``{"flow":
{...}, "gmm": {...}}`` and ``spectral``, named as
``models.train_flow.build_models`` names the modules' parameters and
buffers) and keeps no copy of them. ``normalization.slide.
flow_normalize_slide`` recolours every tile of a slide through it.

Traced (``utils.profiling.annotate``, nothing made when no profiler
records): ``stain.flow`` around each ``transform``, with
``stain.flow.encode`` and ``stain.flow.transfer`` in it; ``stain.flow.fit``
around ``fit`` and ``fit_source``. ``conv_flops_per_call`` counts, from
shapes, the float32 operations of every convolution of the last
``transform`` (flow and GMM head, ``2 Cin Cout k^2`` per output pixel);
``fused_branches_per_call`` counts the flow's residual branches that the
hand-written kernels (``kernels.flow_branch``) computed in it, as each
``IResBlock`` records its last forward: all 15 of the capacity model's on
the card, none on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from stainlib_tpu_torch.models import color_eval
from stainlib_tpu_torch.models.resflow import IResBlock
from stainlib_tpu_torch.models.train_flow import FlowConfig, build_models
from stainlib_tpu_torch.models.validate_flow import (
    TemplateStats, accumulate_template_stats, encode_latent, transfer_batch)
from stainlib_tpu_torch.ops.colorspace import rgb_to_hsd
from stainlib_tpu_torch.utils.profiling import annotate

FLOW_TRANSFERS = ("diag", "full", "quantile", "rgb-quantile")

Tiles = Union[torch.Tensor, Sequence[torch.Tensor]]


def conv_flops(params: dict, n_scales: int, h: int, w: int) -> int:
    """The float32 operations of every convolution of one encode of one
    ``h`` x ``w`` image, from the kernels' shapes: ``2 Cin Cout k^2`` per
    output pixel, the flow's scale ``s`` on the grid halved ``s`` times,
    the GMM head on the latent grid."""
    flops = 0
    for name, wt in params["flow"].items():
        if name.startswith("scales.") and name.endswith(".weight"):
            s = int(name.split(".")[1])
            flops += 2 * wt.numel() * (h >> s) * (w >> s)
    last = n_scales - 1
    for name, wt in params["gmm"].items():
        if name.startswith("convs.") and name.endswith(".weight"):
            flops += 2 * wt.numel() * (h >> last) * (w >> last)
    return flops


class FlowNormalizer:
    """fit / fit_source / transform with the flow + GMM colour model.

    ``transfer``: 'diag' (the reference's per-class affine,
    ``train_img_horo.py:815``), 'full' (Monge maps), 'quantile' or
    'rgb-quantile' (quantile matching in HSD or float RGB); see
    ``models.color_eval``. ``class_match``: rank-match the source's
    classes to the template's by usage (off: the reference's k -> k)."""

    def __init__(self, cfg: FlowConfig, params: dict, spectral: dict,
                 transfer: str = "diag", class_match: bool = False):
        if transfer not in FLOW_TRANSFERS:
            raise ValueError(f"transfer must be one of {FLOW_TRANSFERS}, "
                             f"got {transfer!r}")
        self.cfg = cfg
        self.params, self.spectral = params, spectral
        self.transfer = transfer
        self.class_match = class_match
        # Module templates only: every tensor comes from params / spectral.
        self._flow, self._gmm = build_models(cfg, device="meta")
        self._q_space = "rgb" if transfer == "rgb-quantile" else "hsd"
        self.template: Optional[TemplateStats] = None
        self.source: Optional[TemplateStats] = None
        self._perm = None
        self.latent: Optional[torch.Tensor] = None
        self.conv_flops_per_call = 0
        self.fused_branches_per_call = 0

    def _stats(self, tiles_u8: Tiles) -> TemplateStats:
        """Statistics of uint8 tiles (N, S, S, 3), or of a sequence of such
        batches whose sums add batch by batch."""
        batches = [tiles_u8] if isinstance(tiles_u8, torch.Tensor) \
            else tiles_u8
        return accumulate_template_stats(
            self._flow, self._gmm, self.cfg, self.params, self.spectral,
            [rgb_to_hsd(b) for b in batches],
            return_cov=self.transfer == "full",
            return_quantiles=self.transfer.endswith("quantile"),
            quantile_space=self._q_space)

    def fit(self, template_u8: Tiles) -> TemplateStats:
        """The template's statistics (``train_img_horo.py:676-727``)."""
        with annotate("stain.flow.fit"):
            self.template = self._stats(template_u8)
        self._match()
        return self.template

    def fit_source(self, tiles_u8: Tiles) -> TemplateStats:
        """One source statistic for every later batch (a slide's sampled
        tissue tiles), in place of each batch's own."""
        with annotate("stain.flow.fit"):
            self.source = self._stats(tiles_u8)
        self._match()
        return self.source

    def _match(self):
        self._perm = None
        if (self.class_match and self.template is not None
                and self.source is not None):
            self._perm = color_eval.match_classes_by_usage(
                self.source.usage, self.template.usage)

    def transform(self, batch_u8: torch.Tensor) -> torch.Tensor:
        """uint8 (B, S, S, 3) -> uint8 (B, S, S, 3), recoloured toward the
        template on the batch's device. Without ``fit_source`` each batch's
        own statistics are the source's (``train_img_horo.py:703-705``).
        The flow's latent of the batch stays in ``latent``."""
        t = self.template
        if t is None:
            raise RuntimeError("Call fit(template) before transform().")
        b, h, w = batch_u8.shape[:3]
        with annotate("stain.flow"):
            with annotate("stain.flow.encode"):
                hsd = rgb_to_hsd(batch_u8)
                self.latent, gamma = encode_latent(
                    self._flow, self._gmm, self.params, self.spectral, hsd)
            with annotate("stain.flow.transfer"):
                perm = self._perm
                if self.source is None and self.class_match:
                    perm = color_eval.match_classes_by_usage(
                        color_eval.class_usage(gamma), t.usage)
                out = transfer_batch(hsd, gamma, t.mu, t.sigma, perm, t.cov,
                                     t.quantiles, self._q_space,
                                     source=self.source)
        self.conv_flops_per_call = b * conv_flops(
            self.params, self.cfg.n_scales, h, w)
        self.fused_branches_per_call = sum(
            m.fused for m in self._flow.modules() if isinstance(m, IResBlock))
        return out
