"""Colour-normalization deployment: template transfer + NMI metrics.

Port of the JAX package's ``models/color_eval.py``, the counterpart of the
deployment path and the metric block of ``train_img_horo.py:658-930``:

* per-class HSD colour statistics under the GMM responsibilities (the
  template accumulation of ``train_img_horo.py:676-727``);
* the transfers: ``image_dist_transform`` (``:815,1015``, the per-class
  (mu, sigma) affine) and the extensions (full-covariance Monge maps,
  per-class quantile matching, and the two composed);
* NMI (normalized median intensity) per image and per tissue class
  (``:817-840``), with SD and CV aggregated across images (``:865-885``).

Layout: images and HSD are channels last, (B, H, W, 3), as
``ops.colorspace`` gives them, and so is gamma here: **(B, H, W, K)**, the
JAX package's layout. The flow's ``encode`` returns gamma NCHW, (B, K, H,
W); ``models.validate_flow.encode_gamma`` is the one place that turns it
around.

Rounding. The sums over pixels (the moments, the usage) run in float64 and
round once to float32, so the card and the CPU agree; the eigen-solves of
the Monge maps run in float64 too. The quantiles' cumulative weights are
float32 sums in XLA's own order, the same on every device.
The per-pixel maps are float32 multiplies and adds in a fixed order, the
class-weighted sums accumulate class by class, and the divisions by
constants go through ``ops.fdiv``. Every sort is stable, as ``jnp.argsort``
is.
"""

from __future__ import annotations

import numpy as np
import torch

from stainlib_tpu_torch.ops.colorspace import hsd_to_rgb, to_uint8
from stainlib_tpu_torch.ops.fdiv import fdiv, sum3
from stainlib_tpu_torch.ops.percentile import masked_percentile

# ``np.spacing(np.finfo(np.float32).eps)``: jnp.interp's flat-step test.
_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))


def _f32(x, like=None) -> torch.Tensor:
    dev = None if like is None else like.device
    return torch.as_tensor(x, device=dev).to(torch.float32)


def _wsum(w, x):
    """sum_n w[n, k] * x[n, c] -> (K, C), in float64, rounded once."""
    return (w.double().T @ x.double()).float()


def _outer_wsum(w, x):
    """sum_n w[n, k] * x[n, c] * x[n, d] -> (K, 3, 3), in float64, rounded
    once."""
    xd = x.double()
    outer = (xd[:, :, None] * xd[:, None, :]).reshape(-1, 9)
    return (w.double().T @ outer).float().reshape(-1, 3, 3)


def _flat(a, c: int):
    return a.reshape(-1, c)


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` bit for bit, batched over leading axes:
    ``xp`` and ``fp`` (..., M), ``x`` (..., N) with the same leading axes.

    i = clip(searchsorted(xp, x, right), 1, M - 1); where the step
    ``xp[i] - xp[i-1]`` is at most ``np.spacing(eps32)`` the result is
    ``fp[i-1]``, else ``fp[i-1] + (x - xp[i-1]) / dx * df`` (the last
    multiply and add fused, as XLA computes it); ``fp[0]`` left of
    ``xp[0]`` and ``fp[-1]`` right of ``xp[-1]``."""
    xp = xp.contiguous()
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        1, xp.shape[-1] - 1)
    xp0, xp1 = xp.gather(-1, i - 1), xp.gather(-1, i)
    fp0, fp1 = fp.gather(-1, i - 1), fp.gather(-1, i)
    dx = xp1 - xp0
    flat = dx.abs() <= _INTERP_EPS
    t = (x - xp0) / torch.where(flat, 1.0, dx)
    # XLA contracts the multiply-add into one fused multiply-add: the
    # product of two float32 values is exact in float64, so the float64
    # sum rounded to float32 is the FMA's result.
    f = torch.where(flat, fp0,
                    (fp0.double() + t.double() * (fp1 - fp0).double()).float())
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


_SCAN_BLOCK = 16


def _cumsum(x, dim: int):
    """Float32 cumulative sum along ``dim`` in XLA's order, bit for bit:
    sequential within blocks of 16, the blocks' totals scanned the same
    way (recursively) and added to the blocks that follow. The same adds
    in the same order on every device."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        out = x.clone()
        for j in range(1, n):
            out[..., j] = out[..., j - 1] + x[..., j]
        return out.movedim(-1, dim)
    m = -(-n // _SCAN_BLOCK)
    rows = torch.nn.functional.pad(x, (0, m * _SCAN_BLOCK - n)).reshape(
        x.shape[:-1] + (m, _SCAN_BLOCK))
    rows = _cumsum(rows, -1)
    inc = _cumsum(rows[..., -1], -1)
    carry = torch.nn.functional.pad(inc[..., :-1], (1, 0))
    out = (rows + carry[..., None]).reshape(x.shape[:-1] + (-1,))[..., :n]
    return out.movedim(-1, dim)


def _weighted_curves(xc, w, ps, eps: float = 1e-6):
    """Weighted quantile curves of the rows of ``xc`` (C, N) under the
    weights ``w`` (C, N, K') (one weight column per curve): (C, K', P),
    with each curve's total weight (C, K') and the sorted rows. Sorted
    stably; the cumulative weights in XLA's order (:func:`_cumsum`): an
    interpolation between two neighbours of small weight turns a last-bit
    difference there into a visible one."""
    order = torch.argsort(xc, dim=-1, stable=True)
    xs = xc.gather(-1, order)
    ws = w.gather(1, order[..., None].expand_as(w))
    cw = _cumsum(ws, 1)
    tot = cw[:, -1:]
    cwm = (cw - 0.5 * ws) / torch.clamp_min(tot, eps)         # (C, N, K')
    n_curves = w.shape[-1]
    xp = cwm.permute(0, 2, 1)                                 # (C, K', N)
    fp = xs[:, None, :].expand(-1, n_curves, -1)
    q = ps.expand(xc.shape[0], n_curves, -1)
    return _interp(q, xp, fp), tot[:, -1], xs


def _linspace(n_points: int, device):
    return torch.linspace(0.0, 1.0, n_points, dtype=torch.float32,
                          device=device)


def class_color_stats(hsd, gamma, eps: float = 1e-6):
    """Responsibility-weighted per-class mean/std of HSD channels.

    ``hsd``: (B, H, W, 3); ``gamma``: (B, H, W, K). Returns mu, sigma of
    shape (K, 3): the running template statistics the reference
    accumulates and ``hvd.allreduce``s (``train_img_horo.py:703-727,
    742-744``)."""
    x = _flat(_f32(hsd), 3)
    w = _flat(_f32(gamma, x), gamma.shape[-1])
    tot = w.double().sum(0).float() + eps
    mu = _wsum(w, x) / tot[:, None]
    sq = _wsum(w, x * x) / tot[:, None]
    sigma = torch.sqrt(torch.clamp_min(sq - mu * mu, eps))
    return mu, sigma


def _rgb_out(out, space: str):
    return to_uint8(out if space == "rgb" else hsd_to_rgb(out))


def _class_sum(gamma, maps):
    """sum_k gamma[..., k] * maps(k), class by class: one (B, H, W, 3)
    accumulator, never the (K, B, H, W, 3) stack (64 tiles of 256^2 and
    K = 8 would be 1.6 GB, the comment at ``color_eval.py:210-214``)."""
    acc = None
    for k in range(gamma.shape[-1]):
        term = gamma[..., k:k + 1] * maps(k)
        acc = term if acc is None else acc + term
    return acc


def image_dist_transform(hsd, gamma, mu_src, sigma_src, mu_tmpl, sigma_tmpl,
                         perm=None):
    """Per-class distribution transfer in HSD, responsibility-weighted:

    out = sum_k gamma_k * ((x - mu_src_k) / sigma_src_k * sigma_tmpl_k
                            + mu_tmpl_k)

    Returns uint8 RGB (the deployment output at ``train_img_horo.py:815``).
    ``perm`` (optional, (K,) int): source class k takes the template class
    ``perm[k]``'s statistics (:func:`match_classes_by_usage`); without it
    class k maps to class k, as in the reference."""
    x = _f32(hsd)
    g = _f32(gamma, x)
    mu_t, sd_t = _f32(mu_tmpl, x), _f32(sigma_tmpl, x)
    if perm is not None:
        mu_t, sd_t = mu_t[perm], sd_t[perm]
    mu_s = _f32(mu_src, x)
    sd_s = torch.clamp_min(_f32(sigma_src, x), 1e-6)
    out = _class_sum(g, lambda k: (x - mu_s[k]) / sd_s[k] * sd_t[k]
                     + mu_t[k])
    return to_uint8(hsd_to_rgb(out))


def class_color_cov(hsd, gamma, eps: float = 1e-6):
    """Responsibility-weighted per-class mean and full covariance of the
    HSD channels: (B,H,W,3), (B,H,W,K) -> mu (K,3), cov (K,3,3)
    (extension: the cross-channel terms carry each class's chroma
    orientation, which the diagonal transfer cannot move)."""
    x = _flat(_f32(hsd), 3)
    w = _flat(_f32(gamma, x), gamma.shape[-1])
    tot = w.double().sum(0).float() + eps
    mu = _wsum(w, x) / tot[:, None]
    xx = _outer_wsum(w, x) / tot[:, None, None]
    cov = xx - mu[:, :, None] * mu[:, None, :]
    return mu, cov + eps * torch.eye(3, device=x.device)


def _spd_power(M, p, eps: float = 1e-8):
    """Symmetric power M^p of a batch (K, 3, 3) of SPD matrices by eigh.
    The input is symmetrized first, ``(M + M^T) / 2``, as
    ``jnp.linalg.eigh`` does (``torch.linalg.eigh`` reads one triangle);
    the solve runs in float64 and rounds once."""
    M = _f32(M)
    M = fdiv(M + M.transpose(-1, -2), 2.0)
    w, V = torch.linalg.eigh(M.double())
    w = torch.clamp_min(w, eps) ** p
    return ((V * w[..., None, :]) @ V.transpose(-1, -2)).float()


def monge_maps(cov_src, cov_tmpl):
    """Per-class Gaussian optimal-transport (Monge) matrices (K,3,3):

    A_k = S_k^{-1/2} (S_k^{1/2} T_k S_k^{1/2})^{1/2} S_k^{-1/2}

    the unique SPD linear map with A S A^T = T; it reduces to
    ``sigma_tmpl / sigma_src`` when both covariances are diagonal."""
    S, T = _f32(cov_src), _f32(cov_tmpl)
    s_half = _spd_power(S, 0.5).double()
    s_ihalf = _spd_power(S, -0.5).double()
    inner = (s_half @ T.double() @ s_half).float()
    return (s_ihalf @ _spd_power(inner, 0.5).double() @ s_ihalf).float()


def _affine3(x, A):
    """y[..., d] = sum_c x[..., c] * A[d, c], left to right."""
    return torch.stack([x[..., 0] * A[d, 0] + x[..., 1] * A[d, 1]
                        + x[..., 2] * A[d, 2] for d in range(3)], dim=-1)


def image_dist_transform_full(hsd, gamma, mu_src, cov_src, mu_tmpl, cov_tmpl,
                              perm=None):
    """Full-covariance per-class transfer (extension):

    out = sum_k gamma_k * (A_k (x - mu_src_k) + mu_tmpl_k)

    with A_k the per-class Monge map. Same contract as
    :func:`image_dist_transform`."""
    x = _f32(hsd)
    g = _f32(gamma, x)
    mu_t, cov_t = _f32(mu_tmpl, x), _f32(cov_tmpl, x)
    if perm is not None:
        mu_t, cov_t = mu_t[perm], cov_t[perm]
    A = monge_maps(_f32(cov_src, x), cov_t)
    mu_s = _f32(mu_src, x)
    out = _class_sum(g, lambda k: _affine3(x - mu_s[k], A[k]) + mu_t[k])
    return to_uint8(hsd_to_rgb(out))


def class_channel_quantiles(hsd, gamma, n_points: int = 33,
                            prior_weight: float = 256.0, eps: float = 1e-6):
    """Responsibility-weighted per-class per-channel quantile curves.

    Returns ``(q, mass)``: ``q`` (K, 3, P), the weighted quantile function
    of each class and channel at P evenly spaced probabilities, and
    ``mass`` (K,), the responsibility behind each curve (extension: the
    whole curve captures within-class shifts that are not affine).

    Classes with little mass are shrunk toward the global (class-agnostic)
    curve with weight ``mass / (mass + prior_weight)``, which also covers
    classes the template never uses."""
    x = _flat(_f32(hsd), 3)
    w = _flat(_f32(gamma, x), gamma.shape[-1])
    ps = _linspace(n_points, x.device)
    xc = x.T.contiguous()                                     # (3, N)
    q_cls = _weighted_curves(xc, w[None].expand(3, -1, -1), ps, eps)[0]
    ones = torch.ones((3, x.shape[0], 1), dtype=torch.float32,
                      device=x.device)
    q_glob = _weighted_curves(xc, ones, ps, eps)[0][:, 0]     # (3, P)
    mass = w.double().sum(0).float()
    lam = (mass / (mass + prior_weight))[:, None, None]
    return lam * q_cls.permute(1, 0, 2) + (1.0 - lam) * q_glob, mass


def _check_space(space: str):
    if space not in ("hsd", "rgb"):
        raise ValueError(f"space must be 'hsd' or 'rgb', got {space!r}")


def _channel_map(y, qs, qt):
    """interp(y[..., c], qs[c], qt[c]) per channel: (..., 3) -> (..., 3)."""
    flat = y.reshape(-1, 3).T.contiguous()                    # (3, N)
    return _interp(flat, qs, qt).T.reshape(y.shape)


def image_dist_transform_quantile(hsd, gamma, q_src, q_tmpl, perm=None,
                                  space: str = "hsd"):
    """Per-class monotone quantile-matching transfer (extension):

    out = sum_k gamma_k * interp(x, q_src_k, q_tmpl_k)   (per channel)

    Same contract as :func:`image_dist_transform`. ``space``: ``"hsd"``
    matches the HSD channels and converts back; ``"rgb"`` expects ``hsd``
    and the curves to be float RGB in [0, 255] already and matches the RGB
    channels directly (per-channel scanner tone curves are monotone there,
    so the matching inverts them)."""
    _check_space(space)
    x = _f32(hsd)
    g = _f32(gamma, x)
    qs, qt = _f32(q_src, x), _f32(q_tmpl, x)
    if perm is not None:
        qt = qt[perm]
    out = _class_sum(g, lambda k: _channel_map(x, qs[k], qt[k]))
    return _rgb_out(out, space)


def image_dist_transform_full_quantile(hsd, gamma, mu_src, cov_src,
                                       mu_tmpl, cov_tmpl, q_tmpl,
                                       n_points: int = 33,
                                       prior_weight: float = 256.0,
                                       perm=None, space: str = "hsd"):
    """Composite per-class transfer (extension): the Monge map first, then
    per-channel quantile matching of the mapped values onto the template's
    curves, so that both a chroma rotation and a non-affine marginal shift
    are undone. Same contract as :func:`image_dist_transform`; ``space``
    as in :func:`image_dist_transform_quantile` (with ``"rgb"`` every
    statistic is float RGB too, and no HSD->RGB conversion is applied)."""
    _check_space(space)
    x = _f32(hsd)
    g = _f32(gamma, x)
    mu_t, cov_t, qt = (_f32(mu_tmpl, x), _f32(cov_tmpl, x),
                       _f32(q_tmpl, x))
    if perm is not None:
        mu_t, cov_t, qt = mu_t[perm], cov_t[perm], qt[perm]
    A = monge_maps(_f32(cov_src, x), cov_t)
    mu_s = _f32(mu_src, x)
    ps = _linspace(n_points, x.device)
    n = x.numel() // 3
    cwe = fdiv(torch.arange(n, dtype=torch.float32, device=x.device) + 0.5,
               float(n))

    def class_map(k):
        """Map class k, estimate the mapped values' weighted curves
        (shrunk toward their equal-weight curves where the class mass is
        small), and match them onto the template's."""
        y = _affine3(x - mu_s[k], A[k]) + mu_t[k]
        yc = _flat(y, 3).T.contiguous()                       # (3, N)
        w_k = g[..., k].reshape(1, -1, 1).expand(3, -1, -1)
        q_w, tot, ys = _weighted_curves(yc, w_k, ps)
        q_w, tot = q_w[:, 0], tot[:, 0]                       # (3, P), (3,)
        q_e = _interp(ps.expand(3, -1), cwe.expand(3, -1), ys)
        lam = (tot / (tot + prior_weight))[:, None]
        return _channel_map(y, lam * q_w + (1.0 - lam) * q_e, qt[k])

    return _rgb_out(_class_sum(g, class_map), space)


def class_usage(gamma):
    """Mean responsibility share per class: (..., K) -> (K,), summing to 1.
    Its permutation across centers is the measured mechanism by which
    k -> k transfer fails on out-of-distribution centers."""
    g = _f32(gamma)
    g = g.reshape(-1, g.shape[-1])
    u = fdiv(g.double().sum(0).float(), float(g.shape[0]))
    return u / torch.clamp_min(u.sum(), 1e-12)


def match_classes_by_usage(usage_src, usage_tmpl):
    """Rank-match source GMM classes to template classes by usage share.

    Returns ``perm`` (K,) int32 with ``perm[k]`` the template class whose
    usage rank equals source class k's; equal shares keep index order (a
    stable sort of ``-usage``, as ``jnp.argsort``). The identity whenever
    the two orderings agree."""
    u_s = _f32(usage_src)
    u_t = _f32(usage_tmpl, u_s)
    order_src = torch.argsort(-u_s, stable=True)
    order_tmpl = torch.argsort(-u_t, stable=True)
    perm = torch.zeros(order_src.shape[0], dtype=torch.int32,
                       device=u_s.device)
    perm[order_src] = order_tmpl.to(torch.int32)
    return perm


def nmi(rgb, mask):
    """Normalized median intensity of the masked pixels of an image:
    median(mean-RGB) / 95th-percentile(mean-RGB). ``rgb``: (..., H, W, 3)
    in [0, 255]; ``mask``: (..., H, W) bool; one value per image. The
    reference's per-class statistic is :func:`nmi_per_class`."""
    rgb = _f32(rgb)
    u = fdiv(sum3(rgb), 3.0)
    u = u.reshape(u.shape[:-2] + (-1,))
    m = torch.as_tensor(mask, device=u.device).reshape(u.shape)
    med = masked_percentile(u, m, 50.0)
    p95 = masked_percentile(u, m, 95.0)
    return med / torch.clamp_min(p95, 1e-6)


def nmi_sd_cv(nmi_values):
    """SD and CV of an NMI sample (``train_img_horo.py:865-885``). Host
    numpy over gathered values."""
    v = np.asarray(nmi_values, np.float64)
    sd = float(v.std(ddof=0))
    cv = float(sd / max(v.mean(), 1e-12))
    return sd, cv


def nmi_per_class(rgb, gamma):
    """The reference's NMI statistic (``train_img_horo.py:817-840``): per
    image and per GMM class, median / 95th-percentile of the channel-mean
    intensity over the class's argmax-membership mask.

    ``rgb``: (B, H, W, 3) in [0,255]; ``gamma``: (B, H, W, K). Returns
    (B, K) float64, NaN where a class has no pixels in an image. Host
    numpy: this is the evaluation path."""
    rgb = np.asarray(rgb, np.float64)
    g = np.asarray(gamma)
    cls = np.argmax(g, axis=-1)  # (B, H, W)
    B, K = g.shape[0], g.shape[-1]
    mean_rgb = rgb.mean(axis=-1)
    out = np.full((B, K), np.nan)
    for i in range(B):
        for k in range(K):
            vals = mean_rgb[i][cls[i] == k]
            if vals.size:
                p95 = np.percentile(vals, 95)
                out[i, k] = np.median(vals) / max(p95, 1e-6)
    return out


def class_nmi_sd_cv(nmi_bk):
    """Aggregate :func:`nmi_per_class` values the reference's way
    (``train_img_horo.py:865-898``): per class, SD (Bessel-corrected, as
    ``torch.std``) and CV over the images where the class is present; the
    headline numbers are the averages across present classes. Returns
    (avg_sd, avg_cv, per_class), per_class a list of (class, sd, cv)."""
    v = np.asarray(nmi_bk, np.float64)
    per_class = []
    for k in range(v.shape[1]):
        col = v[:, k]
        col = col[~np.isnan(col)]
        if col.size < 2:
            continue
        sd = float(col.std(ddof=1))
        cv = float(sd / max(col.mean(), 1e-12))
        per_class.append((k, sd, cv))
    if not per_class:
        return float("nan"), float("nan"), per_class
    avg_sd = float(np.mean([s for _, s, _ in per_class]))
    avg_cv = float(np.mean([c for _, _, c in per_class]))
    return avg_sd, avg_cv, per_class
