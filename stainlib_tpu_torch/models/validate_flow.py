"""Validation / deployment of the flow colour normalizer.

Port of the JAX package's ``models/validate_flow.py``, the counterpart of
``train_img_horo.py:658-930`` (``validate``):

  1. template pass over the template batches: gamma, then the
     responsibility-weighted per-class HSD statistics as running sums;
  2. the sums summed across data-parallel ranks (``hvd.allreduce`` at
     ``:742-748``; here ``parallel.collectives.psum_stats`` with a mesh);
  3. deploy pass over the test batches: gamma, the transfer
     (:mod:`stainlib_tpu_torch.models.color_eval`), the per-image NMI;
  4. NMI SD / CV (``:865-885``) and a CSV (``:899-906``).

And ``visualize`` / ``savegamma`` (``:632-656,933-1074``): PNG dumps.

Gamma, the only thing of the flow that deployment reads, does not depend
on the log-determinant's probes, and no step here reads bits/dim. So
gamma comes from :func:`encode_gamma`: the flow's forward with the
log-determinant skipped, under ``torch.inference_mode``, with no
Hutchinson series, no probes and no autograd graph; the JAX package gets
the same from ``encode`` once XLA has dropped the unused series. The
functions that take a ``generator`` in place of the JAX package's ``key``
therefore draw nothing from it.

Everything runs on the device of the parameters (``init_flow_state``'s
``device``, the card unless the caller chose the CPU); batches may be
numpy arrays or tensors.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Iterable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import functional_call

from stainlib_tpu_torch.models import color_eval
from stainlib_tpu_torch.models.gmm import upsample_gamma
from stainlib_tpu_torch.models.train_flow import FlowConfig, _density01
from stainlib_tpu_torch.ops.colorspace import hsd_to_rgb, to_uint8
from stainlib_tpu_torch.ops.tissue import tissue_mask
from stainlib_tpu_torch.utils.meters import Throughput


class TemplateSums(NamedTuple):
    """Sum-decomposable template-statistic state (``train_img_horo.py:
    676-727``): additive across batches and across data-parallel ranks,
    which is what the reference allreduces (``:742-748``). ``xxT`` and
    ``wq`` (full covariance, quantile barycenter) are None unless
    requested."""

    w: Any            # (K,)   responsibility mass
    x: Any            # (K,3)  gamma-weighted HSD sum
    xx: Any           # (K,3)  gamma-weighted HSD^2 sum
    xxT: Any = None   # (K,3,3) gamma-weighted outer-product sum
    wq: Any = None    # (K,3,P) mass-weighted quantile-curve sum


class TemplateStats(NamedTuple):
    """Finalized template statistics; ``usage`` is always there, ``cov``
    and ``quantiles`` only where their sums were requested."""

    mu: Any                 # (K,3)
    sigma: Any              # (K,3)
    usage: Any = None       # (K,)
    cov: Any = None         # (K,3,3)
    quantiles: Any = None   # (K,3,P)


def _device_of(params) -> torch.device:
    return next(iter(params["flow"].values())).device


def _hsd(batch, dev) -> torch.Tensor:
    if not isinstance(batch, torch.Tensor):
        batch = torch.from_numpy(np.array(batch, np.float32))
    return batch.to(device=dev, dtype=torch.float32)


@torch.inference_mode()
def encode_latent(flow, gmm, params, spectral, hsd):
    """The flow's latent z (B, C, H', W') of an HSD batch (B, H, W, 3) and
    the GMM responsibilities gamma (B, H, W, K), channels last as
    :mod:`color_eval` takes them, on the image grid.

    The deploy route: the flow's forward with ``skip_logdet=True`` (no
    probes, no series) and the GMM head, as ``train_flow.encode`` computes
    z and gamma, without bits/dim; any size the flow's squeezes divide."""
    h, w = hsd.shape[-3], hsd.shape[-2]
    z, _ = functional_call(flow, {**params["flow"], **spectral},
                           (_density01(hsd),), {"skip_logdet": True})
    _, (_, _, gamma) = functional_call(
        gmm, params["gmm"], (z, hsd[..., :2].permute(0, 3, 1, 2)))
    return z, upsample_gamma(gamma, h, w).permute(0, 2, 3, 1)


def encode_gamma(flow, gmm, params, spectral, hsd):
    """The gamma of :func:`encode_latent`."""
    return encode_latent(flow, gmm, params, spectral, hsd)[1]


def _batch_sums(flow, gmm, cfg, params, spectral, hsd, generator=None,
                with_cov: bool = False, with_quantiles: bool = False,
                quantile_space: str = "hsd",
                moment_space: str = "hsd") -> TemplateSums:
    """One batch's contribution to the template sums. ``quantile_space``
    selects the channels the quantile curves summarize (the HSD input or
    its float-RGB rendering); ``moment_space`` does the same for the
    moment sums (x, xx, xxT). ``generator``: unused, gamma draws nothing."""
    del generator
    gamma = encode_gamma(flow, gmm, params, spectral, hsd)
    xm = (hsd if moment_space == "hsd" else hsd_to_rgb(hsd)).reshape(-1, 3)
    g = gamma.reshape(-1, gamma.shape[-1])
    w = g.double().sum(0).float()
    x = color_eval._wsum(g, xm)
    xx = color_eval._wsum(g, xm * xm)
    xxT = color_eval._outer_wsum(g, xm) if with_cov else None
    wq = None
    if with_quantiles:
        xq = hsd if quantile_space == "hsd" else hsd_to_rgb(hsd)
        q_b, m_b = color_eval.class_channel_quantiles(xq, gamma)
        wq = m_b[:, None, None] * q_b
    return TemplateSums(w, x, xx, xxT, wq)


def _add(a: Optional[TemplateSums], b: TemplateSums) -> TemplateSums:
    if a is None:
        return b
    return TemplateSums(*(None if u is None else u + v
                          for u, v in zip(a, b)))


def accumulate_template_sums(flow, gmm, cfg: FlowConfig, params, spectral,
                             template_batches: Iterable, generator=None,
                             with_cov: bool = False,
                             with_quantiles: bool = False,
                             quantile_space: str = "hsd",
                             moment_space: str = "hsd") -> TemplateSums:
    """The template sums over all template batches: the running sums of
    ``train_img_horo.py:676-727`` before their allreduce. Under data
    parallelism, ``psum_stats`` them before :func:`finalize_stats`, or use
    :func:`template_sums_sharded`."""
    dev = _device_of(params)
    sums = None
    for hsd in template_batches:
        sums = _add(sums, _batch_sums(
            flow, gmm, cfg, params, spectral, _hsd(hsd, dev),
            with_cov=with_cov, with_quantiles=with_quantiles,
            quantile_space=quantile_space, moment_space=moment_space))
    return sums


def template_sums_sharded(flow, gmm, cfg: FlowConfig, params, spectral,
                          hsd, generator, mesh, axis_name: str = "data",
                          with_cov: bool = False,
                          with_quantiles: bool = False,
                          quantile_space: str = "hsd",
                          moment_space: str = "hsd") -> TemplateSums:
    """One global template batch sharded over ``mesh[axis_name]``: each
    rank takes its rows (``parallel.mesh.shard_rows``), computes their sums
    (the quantile curves of its rows included, weighted by their own mass,
    as each JAX shard computes them), and the sums are added over the axis
    in rank order (``psum_stats``, the reference's ``hvd.allreduce``,
    ``train_img_horo.py:742-748``). Every rank returns the same sums.
    ``hsd`` is the whole batch on every rank; its size must divide by the
    axis size."""
    from stainlib_tpu_torch.parallel.collectives import psum_stats
    from stainlib_tpu_torch.parallel.mesh import shard_rows

    rows = shard_rows(mesh, axis_name, tuple(hsd.shape))
    local = _hsd(hsd[rows], _device_of(params))
    s = _batch_sums(flow, gmm, cfg, params, spectral, local,
                    with_cov=with_cov, with_quantiles=with_quantiles,
                    quantile_space=quantile_space,
                    moment_space=moment_space)
    return TemplateSums(*psum_stats(tuple(s), mesh, axis_name))


def finalize_template_stats(sum_w, sum_x, sum_xx, eps: float = 1e-6):
    """Moments -> (mu, sigma). Under data parallelism, sum the three over
    the ranks first (the allreduce of ``:742-744``)."""
    tot = torch.clamp_min(sum_w, eps)[:, None]
    mu = sum_x / tot
    sigma = torch.sqrt(torch.clamp_min(sum_xx / tot - mu * mu, eps))
    return mu, sigma


def finalize_stats(sums: TemplateSums, eps: float = 1e-6) -> TemplateStats:
    """:class:`TemplateSums` (after any sum over ranks) ->
    :class:`TemplateStats`."""
    mu, sigma = finalize_template_stats(sums.w, sums.x, sums.xx, eps)
    usage = sums.w / torch.clamp_min(sums.w.sum(), 1e-12)
    cov = None
    if sums.xxT is not None:
        tot = torch.clamp_min(sums.w, eps)[:, None, None]
        cov = (sums.xxT / tot - mu[:, :, None] * mu[:, None, :]
               + 1e-6 * torch.eye(3, device=mu.device))
    quantiles = None
    if sums.wq is not None:
        quantiles = sums.wq / torch.clamp_min(sums.w, eps)[:, None, None]
    return TemplateStats(mu, sigma, usage, cov, quantiles)


def accumulate_template_stats(flow, gmm, cfg: FlowConfig, params, spectral,
                              template_batches: Iterable, generator=None,
                              return_usage: bool = True,
                              return_cov: bool = False,
                              return_quantiles: bool = False,
                              quantile_space: str = "hsd",
                              moment_space: str = "hsd") -> TemplateStats:
    """Template statistics over all template batches
    (``train_img_horo.py:676-727``): (mu, sigma) (K, 3) and the usage
    shares (K,); with ``return_cov`` the (K, 3, 3) covariances, with
    ``return_quantiles`` the (K, 3, P) quantile curves (the mass-weighted
    average of the per-batch curves). ``return_usage`` is kept for the
    signature; usage is always computed."""
    del return_usage
    sums = accumulate_template_sums(
        flow, gmm, cfg, params, spectral, template_batches, generator,
        with_cov=return_cov, with_quantiles=return_quantiles,
        quantile_space=quantile_space, moment_space=moment_space)
    return finalize_stats(sums)


def transfer_batch(hsd, gamma, mu_t, sd_t, perm=None, cov_t=None, q_t=None,
                   q_space: str = "hsd", composite: bool = False,
                   source: Optional[TemplateStats] = None):
    """One deploy batch's transfer, uint8 RGB out. The source statistics
    are the batch's own (the reference's one (mu, sigma) per deploy batch,
    ``train_img_horo.py:703-705``, applied at ``:815``), or ``source``'s,
    fitted once (a slide's). The template's ``cov_t`` / ``q_t`` select the
    transfer as in :func:`deploy`."""
    xq = hsd if q_space == "hsd" or q_t is None else hsd_to_rgb(hsd)
    if composite and q_t is not None and cov_t is not None:
        mu_s, cov_s = (color_eval.class_color_cov(xq, gamma)
                       if source is None else (source.mu, source.cov))
        return color_eval.image_dist_transform_full_quantile(
            xq, gamma, mu_s, cov_s, mu_t, cov_t, q_t, perm=perm,
            space=q_space)
    if q_t is not None:
        q_s = (color_eval.class_channel_quantiles(xq, gamma)[0]
               if source is None else source.quantiles)
        return color_eval.image_dist_transform_quantile(
            xq, gamma, q_s, q_t, perm=perm, space=q_space)
    if cov_t is not None:
        mu_s, cov_s = (color_eval.class_color_cov(hsd, gamma)
                       if source is None else (source.mu, source.cov))
        return color_eval.image_dist_transform_full(
            hsd, gamma, mu_s, cov_s, mu_t, cov_t, perm=perm)
    mu_s, sd_s = (color_eval.class_color_stats(hsd, gamma)
                  if source is None else (source.mu, source.sigma))
    return color_eval.image_dist_transform(hsd, gamma, mu_s, sd_s, mu_t,
                                           sd_t, perm=perm)


def deploy(flow, gmm, cfg: FlowConfig, params, spectral, test_batches,
           mu_tmpl, sigma_tmpl, generator=None, log=print, usage_tmpl=None,
           cov_tmpl=None, q_tmpl=None, pooled_usage: bool = False,
           q_space: str = "hsd", composite: bool = False):
    """Deploy pass: recolour every test batch toward the template and
    collect the NMI of the output (``train_img_horo.py:750-862``).

    Returns ``(nmi_values, recolored_batches, (class_nmi, class_nmi_raw))``,
    the last pair the reference's per-class NMI (``color_eval.
    nmi_per_class``, (N, K)) of the output and of the input. Logs imgs/s
    per batch (the reference's print at ``:862``).

    ``usage_tmpl`` (K,): rank-match each batch's classes to the template's
    by usage before the transfer; None keeps the reference's k -> k.
    ``cov_tmpl`` (K,3,3): full-covariance Monge transfer. ``q_tmpl``
    (K,3,P): per-class quantile matching, which takes precedence over
    ``cov_tmpl``; ``q_space`` ('hsd' | 'rgb') is the space the curves were
    accumulated and are matched in. ``composite`` (with both): the Monge
    map, then the quantile correction; ``mu_tmpl`` is then in ``q_space``
    too. ``pooled_usage`` (with ``usage_tmpl``): one permutation from the
    usage summed over all test batches (one more gamma pass), instead of
    one per batch."""
    dev = _device_of(params)
    mu_t, sd_t = _hsd(mu_tmpl, dev), _hsd(sigma_tmpl, dev)
    usage_t, cov_t, q_t = (None if a is None else _hsd(a, dev)
                           for a in (usage_tmpl, cov_tmpl, q_tmpl))

    def gamma_of(hsd):
        return encode_gamma(flow, gmm, params, spectral, hsd)

    perm_pooled = None
    if pooled_usage and usage_t is not None:
        test_batches = [_hsd(b, dev) for b in test_batches]
        w_sum = None
        for hsd in test_batches:
            g = gamma_of(hsd)
            w = g.reshape(-1, g.shape[-1]).double().sum(0).float()
            w_sum = w if w_sum is None else w_sum + w
        perm_pooled = color_eval.match_classes_by_usage(
            w_sum / torch.clamp_min(w_sum.sum(), 1e-12), usage_t)
    nmis, outs, class_nmis, class_nmis_raw = [], [], [], []
    meter = Throughput()
    for hsd in test_batches:
        hsd = _hsd(hsd, dev)
        gamma = gamma_of(hsd)
        perm = perm_pooled
        if perm is None and usage_t is not None:
            perm = color_eval.match_classes_by_usage(
                color_eval.class_usage(gamma), usage_t)
        rgb = transfer_batch(hsd, gamma, mu_t, sd_t, perm, cov_t, q_t, q_space,
                        composite)
        nmis += color_eval.nmi(rgb, tissue_mask(rgb).mask).tolist()
        # One host copy each of rgb and gamma, reused below.
        rgb_np = rgb.cpu().numpy()
        gamma_np = gamma.cpu().numpy()
        class_nmis.append(color_eval.nmi_per_class(rgb_np, gamma_np))
        class_nmis_raw.append(color_eval.nmi_per_class(
            to_uint8(hsd_to_rgb(hsd)).cpu().numpy(), gamma_np))
        outs.append(rgb_np)
        log(f"deploy: {meter.tick(int(rgb.shape[0])):.1f} imgs/sec")
    return np.asarray(nmis), outs, (np.concatenate(class_nmis),
                                    np.concatenate(class_nmis_raw))


TRANSFERS = ("diag", "full", "quantile", "rgb-quantile", "full-quantile",
             "rgb-full-quantile")


def validate(flow, gmm, cfg: FlowConfig, params, spectral,
             template_batches, test_batches, generator=None,
             out_dir: Optional[str] = None, log=print,
             class_match: bool = False, transfer: str = "diag",
             mesh=None, axis_name: str = "data",
             pooled_class_match: bool = False):
    """Template statistics -> deploy -> NMI SD/CV (+ CSV).

    ``class_match``: usage-rank class matching at deploy (off: the
    reference's k -> k). ``transfer``: 'diag', the reference's per-channel
    affine (``train_img_horo.py:815``); 'full', per-class Monge maps;
    'quantile', per-class quantile matching; 'rgb-quantile', the same on
    the float-RGB rendering; 'full-quantile' / 'rgb-full-quantile', the
    Monge map then the quantile correction, in HSD / RGB (the extensions
    of ``color_eval``). ``mesh``: each template batch is sharded over
    ``mesh[axis_name]`` and its sums added over the axis
    (:func:`template_sums_sharded`); the batch size must divide by the
    axis size. ``pooled_class_match``: one permutation for the whole test
    set (see :func:`deploy`)."""
    if transfer not in TRANSFERS:
        raise ValueError(f"transfer must be one of {TRANSFERS}, "
                         f"got {transfer!r}")
    q_space = "rgb" if transfer.startswith("rgb-") else "hsd"
    with_q = transfer.endswith("quantile")
    composite = transfer in ("full-quantile", "rgb-full-quantile")
    with_cov = transfer == "full" or composite
    # The composite takes mu and cov in the space of its quantile curves;
    # plain 'full' keeps the HSD moments.
    m_space = q_space if composite else "hsd"
    kw = dict(with_cov=with_cov, with_quantiles=with_q,
              quantile_space=q_space, moment_space=m_space)
    if mesh is not None:
        sums = None
        for hsd in template_batches:
            sums = _add(sums, template_sums_sharded(
                flow, gmm, cfg, params, spectral, hsd, None, mesh,
                axis_name=axis_name, **kw))
        stats = finalize_stats(sums)
    else:
        stats = finalize_stats(accumulate_template_sums(
            flow, gmm, cfg, params, spectral, template_batches, **kw))
    nmis, outs, (cls_nmi, cls_nmi_raw) = deploy(
        flow, gmm, cfg, params, spectral, test_batches, stats.mu,
        stats.sigma, log=log,
        usage_tmpl=stats.usage if class_match else None,
        cov_tmpl=stats.cov, q_tmpl=stats.quantiles,
        pooled_usage=pooled_class_match, q_space=q_space,
        composite=composite)
    sd, cv = color_eval.nmi_sd_cv(nmis)
    # The reference's metric: per-class SD/CV averaged across classes
    # (train_img_horo.py:865-898), before and after recolouring.
    csd, ccv, per_class = color_eval.class_nmi_sd_cv(cls_nmi)
    csd_raw, ccv_raw, _ = color_eval.class_nmi_sd_cv(cls_nmi_raw)
    log(f"validate: NMI sd={sd:.4f} cv={cv:.4f} over {len(nmis)} images; "
        f"per-class avg sd={csd:.4f} cv={ccv:.4f} "
        f"(raw {csd_raw:.4f}/{ccv_raw:.4f})")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "nmi_metrics.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["nmi"])
            w.writerows([[v] for v in nmis])
            w.writerow([])
            w.writerow(["sd", sd])
            w.writerow(["cv", cv])
    host = TemplateStats(*(None if t is None else t.cpu().numpy()
                           for t in stats))
    return {"nmi_sd": sd, "nmi_cv": cv, "nmi": nmis, "outputs": outs,
            "class_nmi_sd": csd, "class_nmi_cv": ccv,
            "class_nmi_sd_raw": csd_raw, "class_nmi_cv_raw": ccv_raw,
            "class_nmi": cls_nmi, "class_nmi_per_class": per_class,
            "mu_tmpl": host.mu, "sigma_tmpl": host.sigma, "stats": host}


def save_visuals(out_dir: str, step: int, hsd_tmpl, hsd_test, rgb_converted,
                 gamma):
    """PNG dumps of the template, test and converted images and the class
    membership map (``visualize`` / ``savegamma``, ``train_img_horo.py:
    632-656,933-1074``). ``gamma``: (B, H, W, K)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)

    def dump(name, arr):
        Image.fromarray(np.asarray(arr)).save(
            os.path.join(out_dir, f"{name}_{step:06d}.png"))

    def rgb_u8(hsd):
        return to_uint8(hsd_to_rgb(torch.as_tensor(hsd[0]))).cpu().numpy()

    dump("im_tmpl", rgb_u8(hsd_tmpl))
    dump("im_test", rgb_u8(hsd_test))
    dump("im_conv", np.asarray(rgb_converted[0]))
    # Class-membership colour map: argmax class -> distinct hue.
    g = torch.as_tensor(gamma[0])
    k = g.shape[-1]
    palette = np.linspace(0, 255, k)[:, None] * np.array([[1.0, 0.5, 0.25]])
    classes = torch.argmax(g, dim=-1).cpu().numpy()
    dump("im_gamma", palette[classes].astype(np.uint8))
