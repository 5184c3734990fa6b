"""The plain reference of the functional fit: tissue mask, optical density,
the Macenko and Vahadane stain-matrix estimates and ``fit``.

A frozen copy of the port's functional path (``ops/``, ``extraction/`` and
``normalization/extractive.fit`` of ``stainlib_tpu_torch``), plain torch
operations only, importing nothing of the port: the benchmark recomputes
the target's and the slide's stain parameters with it and holds the
program's fit to them. Every function keeps the port's arithmetic (float64
transcendentals and pixel contractions rounded once, constant divisions by
a 0-dim tensor, three-element sums left to right), so on one device the two
give the same bits.

``low`` (a torch dtype or None) is the control's knob: every per-pixel
intermediate (the optical density, the lasso's concentrations) is rounded
through that dtype, as a kernel that held them in it would compute.
``None`` is the reference itself.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

# OpenCV's RGB->XYZ matrix, its luminance row (ITU-R BT.709, D65).
_RGB2XYZ_Y = np.array([0.212671, 0.715160, 0.072169], dtype=np.float32)
_LAB_DELTA = 0.008856  # (6/29)^3 threshold of the CIE f() function
_LAB_KAPPA = 903.3  # OpenCV's low-Y L* slope

# Ruifrok-Johnston H & E optical-density directions (row-normalized), the
# dictionary learner's deterministic start.
_HE_INIT = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]],
                    dtype=np.float32)
_HE_INIT /= np.linalg.norm(_HE_INIT, axis=1, keepdims=True)

_BISECT_THRESHOLD = 512 * 512
_BISECT_CANDS = 7  # interior candidates per round: each narrows 8x
_BISECT_ROUNDS = 8  # 8 rounds * 3 bits = a 2^-24 bracket
_BIG = 3.4e38


def lowp(x, low):
    """``x`` rounded through the dtype ``low`` and back (None: ``x``)."""
    return x if low is None else x.to(low).to(x.dtype)


# ---------------------------------------------------------------------------
# Arithmetic that rounds the same on every device.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _const(d: float, dtype, device):
    return torch.tensor(d, dtype=dtype, device=device)


def fdiv(x, d: float):
    """``x / d``, rounded once in ``x``'s dtype on every device."""
    return x / _const(float(d), x.dtype, x.device)


def f64(fn, *args):
    """``fn(*args)`` evaluated in float64, rounded once to float32."""
    return fn(*(a.double() if isinstance(a, torch.Tensor) else a
                for a in args)).float()


def sum3(x):
    """``x[..., 0] + x[..., 1] + x[..., 2]``, left to right."""
    return x[..., 0] + x[..., 1] + x[..., 2]


# ---------------------------------------------------------------------------
# Colour space and tissue mask.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _byte_table(fn, device):
    """``fn`` over the 256 byte values as float32, built on the CPU."""
    return fn(torch.arange(256, dtype=torch.float32)).to(device)


def _per_byte(fn, rgb):
    """``fn(rgb.float())``: for uint8 ``rgb`` a gather from a table."""
    rgb = torch.as_tensor(rgb)
    if rgb.dtype == torch.uint8:
        return _byte_table(fn, rgb.device)[rgb.to(torch.int32)]
    return fn(rgb.to(torch.float32))


def _cbrt(x):
    return f64(torch.pow, x, 1.0 / 3.0)


def _linear_of_byte_scale(x):
    """A channel in [0,255] -> linear [0,1] (the sRGB expansion)."""
    c = fdiv(x, 255.0)
    return torch.where(c <= 0.04045, fdiv(c, 12.92),
                       f64(torch.pow, fdiv(c + 0.055, 1.055), 2.4))


def lab_luminance(rgb):
    """L channel of CIELAB in [0,100] (OpenCV's 8-bit conversion)."""
    lin = _per_byte(_linear_of_byte_scale, rgb)
    m = _RGB2XYZ_Y
    Y = (lin[..., 0] * float(m[0]) + lin[..., 1] * float(m[1])
         + lin[..., 2] * float(m[2]))
    return torch.where(Y > _LAB_DELTA, 116.0 * _cbrt(Y) - 16.0,
                       _LAB_KAPPA * Y)


def _od_of_channel(x):
    return torch.clamp_min(
        -f64(torch.log, fdiv(torch.clamp_min(x, 1.0), 255.0)), 1e-6)


def rgb_to_od(rgb, low=None):
    """RGB [0,255] -> optical density ``max(-log(max(I,1)/255), 1e-6)``."""
    return lowp(_per_byte(_od_of_channel, rgb), low)


class TissueMask(NamedTuple):
    mask: torch.Tensor  # (..., H, W) bool
    count: torch.Tensor  # (...,) int32


def tissue_mask(rgb, luminosity_threshold: float = 0.8) -> TissueMask:
    """Luminosity tissue mask over (..., H, W, 3) RGB in [0,255]."""
    L = fdiv(lab_luminance(rgb), 100.0)
    mask = L < luminosity_threshold
    return TissueMask(mask=mask, count=mask.sum((-2, -1)).to(torch.int32))


# ---------------------------------------------------------------------------
# The closed-form symmetric 3x3 eigendecomposition, in float64.
# ---------------------------------------------------------------------------

def _cross(u, v):
    return torch.stack([
        u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0],
    ], dim=-1)


def _det3(M):
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def eigh3x3_f64(A, eps: float = 1e-12):
    """Eigenvalues (ascending) and unit eigenvectors (columns) of symmetric
    3x3 ``A``, solved in float64 and rounded once to float32."""
    w, V = _eigh3x3(torch.as_tensor(A).to(torch.float64), eps)
    return w.to(torch.float32), V.to(torch.float32)


def _eigh3x3(A, eps):
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    scale = torch.clamp_min(A.abs().amax((-2, -1), keepdim=True), eps)
    As = A / scale
    q = fdiv(torch.diagonal(As, dim1=-2, dim2=-1).sum(-1), 3.0)
    B = As - q[..., None, None] * eye
    p2 = fdiv((B * B).sum((-2, -1)), 6.0)
    p = torch.sqrt(torch.clamp_min(p2, eps * eps))
    detB = _det3(B / p[..., None, None])
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = fdiv(torch.arccos(r), 3.0)
    w2 = q + 2.0 * p * torch.cos(phi)  # largest
    w0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    w1 = 3.0 * q - w0 - w2
    w = torch.stack([w0, w1, w2], dim=-1)
    V = torch.stack([_eigvec(As, w[..., k], eps) for k in range(3)], dim=-1)
    return w * scale[..., 0, 0][..., None], V


def _eigvec(A, lam, eps):
    """Unit eigenvector for ``lam`` by the largest cross product of the
    columns of (A - lam I), sign-fixed."""
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype,
                                             device=A.device)
    c0, c1, c2 = M[..., :, 0], M[..., :, 1], M[..., :, 2]
    x01, x02, x12 = _cross(c0, c1), _cross(c0, c2), _cross(c1, c2)
    n01 = (x01 * x01).sum(-1)
    n02 = (x02 * x02).sum(-1)
    n12 = (x12 * x12).sum(-1)
    best12 = (n12 >= n01) & (n12 >= n02)
    best02 = (~best12) & (n02 >= n01)
    v = torch.where(best12[..., None], x12,
                    torch.where(best02[..., None], x02, x01))
    nv = torch.sqrt((v * v).sum(-1, keepdim=True))
    e0 = torch.zeros_like(v)
    e0[..., 0] = 1.0
    v = torch.where(nv > eps, v / torch.clamp_min(nv, eps), e0)
    idx = torch.argmax(v.abs(), dim=-1, keepdim=True)
    lead = torch.gather(v, -1, idx)[..., 0]
    return v * torch.where(lead < 0, -1.0, 1.0)[..., None]


# ---------------------------------------------------------------------------
# Percentiles (NumPy's linear rule; count bisection above 512^2 values).
# ---------------------------------------------------------------------------

def _percentile_bisect(values, mask, q, n_rounds=_BISECT_ROUNDS,
                       n_cands=_BISECT_CANDS):
    """np.percentile(values[mask], q) along the last axis by multi-candidate
    count bisection, both ranks snapped to data values. An empty mask gives
    +inf."""
    v = torch.as_tensor(values).to(torch.float32)
    big = torch.tensor(_BIG, dtype=torch.float32, device=v.device)
    if mask is None:
        vm = v
        n = torch.full(v.shape[:-1], float(v.shape[-1]), dtype=torch.float32,
                       device=v.device)
    else:
        vm = torch.where(mask, v, big)
        n = mask.sum(-1).to(torch.float32)
    q = torch.as_tensor(q, dtype=torch.float32, device=v.device)
    scalar_q = q.ndim == 0
    qv = q.reshape(-1)
    rank = (fdiv(qv.reshape(qv.shape + (1,) * (v.ndim - 1)), 100.0)
            * torch.clamp_min(n - 1.0, 0.0))
    rank_lo = torch.floor(rank)
    frac = rank - rank_lo

    lo = torch.where(vm < big, vm, big).amin(-1)
    hi = torch.where(vm < big, vm, -big).amax(-1)
    hi = torch.maximum(hi, lo)
    lo = lo.expand(rank.shape)
    hi = hi.expand(rank.shape)

    for _ in range(n_rounds):
        step = (hi - lo) / float(n_cands + 1)
        new_lo, new_hi = lo, hi
        for j in range(1, n_cands + 1):
            mid = lo + step * float(j)
            cnt = (vm[None] <= mid[..., None]).sum(-1)
            take = cnt > rank_lo
            new_lo = torch.where(take, new_lo, mid)
            new_hi = torch.where(take, torch.minimum(new_hi, mid), new_hi)
        lo, hi = new_lo, new_hi
    hi_a = hi
    below = vm[None] <= hi_a[..., None]
    v_a = torch.where(below, vm[None], -big).amax(-1)
    cnt_hi = below.sum(-1)
    succ = torch.where(vm[None] > hi_a[..., None], vm[None], big).amin(-1)
    v_b = torch.where(cnt_hi > rank_lo + 1.0, v_a, succ)
    out = v_a * (1.0 - frac) + v_b * frac
    out = torch.where(n > 0.0, out, torch.inf)
    return out[0] if scalar_q else out


def _sorted_percentile(a, q):
    """The linear rule on the last axis of ``a`` by a sort."""
    a = torch.where(torch.isnan(a).any(-1, keepdim=True), torch.nan, a)
    a = torch.sort(a, dim=-1).values
    n = a.shape[-1]
    qf = fdiv(torch.as_tensor(q, dtype=torch.float32, device=a.device), 100.0)
    qr = qf * float(n - 1)
    low = torch.floor(qr)
    high = torch.ceil(qr)
    hw = qr - low
    lw = 1.0 - hw
    low = torch.clamp(low, 0, n - 1).to(torch.long)
    high = torch.clamp(high, 0, n - 1).to(torch.long)
    out = a[..., low] * lw + a[..., high] * hw
    return out if qf.ndim == 0 else torch.movedim(out, -1, 0)


def percentile(x, q, axis: int):
    """``np.percentile(x, q, axis)``, linear interpolation."""
    x = torch.as_tensor(x).to(torch.float32)
    if x.shape[axis] > _BISECT_THRESHOLD:
        return _percentile_bisect(torch.movedim(x, axis, -1), None, q)
    return _sorted_percentile(torch.movedim(x, axis, -1), q)


def masked_percentile(values, mask, q):
    """Percentile of ``values[mask]`` along the last axis; ``q`` a scalar
    or an (m,) vector stacked on a leading axis."""
    values = torch.as_tensor(values).to(torch.float32)
    if values.shape[-1] > _BISECT_THRESHOLD:
        return _percentile_bisect(values, mask, q)
    v = torch.sort(torch.where(mask, values, torch.inf), dim=-1).values
    n = mask.sum(-1).to(torch.float32)
    qa = torch.as_tensor(q, dtype=torch.float32, device=values.device)
    qv = qa.reshape(-1)
    rank = (fdiv(qv.reshape(qv.shape + (1,) * n.ndim), 100.0)
            * torch.clamp_min(n - 1.0, 0.0))
    lo = torch.floor(rank).to(torch.long)
    hi = torch.ceil(rank).to(torch.long)
    frac = rank - lo.to(torch.float32)
    vb = v.expand(rank.shape + v.shape[-1:])
    v_lo = torch.gather(vb, -1, lo[..., None])[..., 0]
    v_hi = torch.gather(vb, -1, hi[..., None])[..., 0]
    out = v_lo * (1.0 - frac) + v_hi * frac
    return out[0] if qa.ndim == 0 else out


# ---------------------------------------------------------------------------
# The exact non-negative K=2 lasso and the dictionary learner.
# ---------------------------------------------------------------------------

def nonneg_lasso_k2(od, stain_matrix, regularizer: float = 0.01, low=None):
    """Exact concentrations (..., 2) of ``min_{c>=0} 0.5||x - M^T c||^2 +
    lambda ||c||_1`` for optical densities (..., 3) against stain rows
    (..., 2, 3)."""
    od = torch.as_tensor(od).to(torch.float32)
    M = torch.as_tensor(stain_matrix, device=od.device).to(torch.float32)
    g11 = sum3(M[..., 0, :] * M[..., 0, :])
    g22 = sum3(M[..., 1, :] * M[..., 1, :])
    g12 = sum3(M[..., 0, :] * M[..., 1, :])
    det = torch.clamp_min(g11 * g22 - g12 * g12, 1e-12)

    b1 = sum3(od * M[..., 0, :]) - regularizer
    b2 = sum3(od * M[..., 1, :]) - regularizer

    c1_full = (g22 * b1 - g12 * b2) / det
    c2_full = (g11 * b2 - g12 * b1) / det
    ok_full = (c1_full >= 0.0) & (c2_full >= 0.0)
    c1_only = torch.clamp_min(b1, 0.0) / torch.clamp_min(g11, 1e-12)
    ok_1 = (b1 >= 0.0) & (g12 * c1_only - b2 >= 0.0)
    c2_only = torch.clamp_min(b2, 0.0) / torch.clamp_min(g22, 1e-12)
    ok_2 = (b2 >= 0.0) & (g12 * c2_only - b1 >= 0.0)

    c1 = torch.where(ok_full, c1_full, torch.where(ok_1, c1_only, 0.0))
    c2 = torch.where(ok_full, c2_full,
                     torch.where(~ok_1 & ok_2, c2_only, 0.0))
    return lowp(torch.stack([c1, c2], dim=-1), low)


def get_concentrations(rgb, stain_matrix, regularizer: float = 0.01,
                       low=None):
    """RGB (..., H, W, 3) -> concentrations (..., H, W, 2) over every
    pixel."""
    od = rgb_to_od(rgb, low)
    stain_matrix = torch.as_tensor(stain_matrix, device=od.device)
    if stain_matrix.ndim > 2:
        stain_matrix = stain_matrix[..., None, None, :, :]
    return nonneg_lasso_k2(od, stain_matrix, regularizer, low)


def fit_stain_dictionary(od, mask, regularizer: float = 0.1,
                         num_iters: int = 30, init=None, low=None):
    """The 2x3 stain dictionary by alternating the exact sparse codes with
    two block-coordinate sweeps over the rows (non-negative, unit ball),
    from the masked statistics accumulated in float64."""
    od = torch.as_tensor(od).to(torch.float32)
    w = torch.as_tensor(mask, device=od.device).to(torch.float32)
    if init is None:
        D = torch.as_tensor(_HE_INIT, device=od.device).expand(
            od.shape[:-2] + (2, 3))
    else:
        D = torch.as_tensor(init, device=od.device).to(torch.float32)
    D = D.clone()

    for _ in range(num_iters):
        A = nonneg_lasso_k2(od, D[..., None, :, :], regularizer, low)
        Aw = A * w[..., None]
        C = torch.einsum("...nk,...nl->...kl", Aw.double(),
                         A.double()).float()
        B = torch.einsum("...nk,...nc->...kc", Aw.double(),
                         od.double()).float()
        for _sweep in range(2):
            for j in range(2):
                cjj = torch.clamp_min(C[..., j, j], 1e-8)
                resid = B[..., j, :] - (C[..., j, 0, None] * D[..., 0, :]
                                        + C[..., j, 1, None] * D[..., 1, :])
                u = D[..., j, :] + resid / cjj[..., None]
                u = torch.clamp_min(u, 0.0)
                norm = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
                u = u / torch.clamp_min(norm, 1.0)
                dead = u.sum(-1, keepdim=True) <= 0.0
                D[..., j, :] = torch.where(dead, D[..., j, :], u)
    return D


# ---------------------------------------------------------------------------
# Stain-matrix estimates and the fit.
# ---------------------------------------------------------------------------

def stain_matrix_macenko(rgb, luminosity_threshold: float = 0.8,
                         angular_percentile: float = 99.0, low=None):
    """(..., H, W, 3) RGB -> (..., 2, 3) Macenko stain matrix, H first
    (Macenko et al. 2009); NaN rows for an empty tissue mask."""
    rgb = torch.as_tensor(rgb)
    mask = tissue_mask(rgb, luminosity_threshold).mask
    od = rgb_to_od(rgb, low)
    lead = od.shape[:-3]
    n_pix = od.shape[-3] * od.shape[-2]
    od = od.reshape(lead + (n_pix, 3))
    m = mask.reshape(lead + (n_pix,)).to(torch.float32)
    return stain_matrix_macenko_from_od(od, m, angular_percentile)


def stain_matrix_macenko_from_od(od, m, angular_percentile: float = 99.0):
    """Macenko estimate from flattened OD (..., N, 3) and tissue weights
    (..., N): masked covariance (N-1), top-2 eigenplane, angular
    percentiles, H-first row-normalized rows."""
    n = m.sum(-1)
    safe_n = torch.clamp_min(n, 1.0)
    mean = (torch.einsum("...n,...nc->...c", m.double(), od.double())
            .float() / safe_n[..., None])
    centered = od - mean[..., None, :]
    diff = centered * m[..., None]
    cov = torch.einsum("...nc,...nd->...cd", diff.double(),
                       centered.double()).float()
    cov = cov / torch.clamp_min(n - 1.0, 1.0)[..., None, None]

    _, V = eigh3x3_f64(cov)
    V2 = V[..., :, [2, 1]]
    V2 = V2 * torch.where(V2[..., 0:1, :] < 0.0, -1.0, 1.0)

    That = torch.einsum("...nc,...ck->...nk", od, V2)
    phi = f64(torch.atan2, That[..., 1], That[..., 0])
    min_phi, max_phi = masked_percentile(
        phi, m > 0.0,
        torch.tensor([100.0 - angular_percentile, angular_percentile],
                     dtype=torch.float32, device=od.device))

    v1 = (V2[..., 0] * f64(torch.cos, min_phi)[..., None]
          + V2[..., 1] * f64(torch.sin, min_phi)[..., None])
    v2 = (V2[..., 0] * f64(torch.cos, max_phi)[..., None]
          + V2[..., 1] * f64(torch.sin, max_phi)[..., None])

    first = v1[..., 0] > v2[..., 0]
    h = torch.where(first[..., None], v1, v2)
    e = torch.where(first[..., None], v2, v1)
    HE = torch.stack([h, e], dim=-2)
    HE = HE / torch.sqrt(sum3(HE * HE))[..., None]
    return torch.where((n > 0.0)[..., None, None], HE, torch.nan)


def stain_matrix_vahadane(rgb, luminosity_threshold: float = 0.8,
                          regularizer: float = 0.1, num_iters: int = 12,
                          low=None):
    """(..., H, W, 3) RGB -> (..., 2, 3) Vahadane stain matrix (Vahadane et
    al. 2016), the dictionary learner warm-started from the Macenko
    estimate; H first, rows normalized; NaN rows for an empty mask."""
    rgb = torch.as_tensor(rgb)
    tm = tissue_mask(rgb, luminosity_threshold)
    od = rgb_to_od(rgb, low)
    lead = od.shape[:-3]
    n_pix = od.shape[-3] * od.shape[-2]
    od = od.reshape(lead + (n_pix, 3))
    mask = tm.mask.reshape(lead + (n_pix,))

    mac = stain_matrix_macenko_from_od(od, mask.to(torch.float32))
    prior = torch.as_tensor(_HE_INIT, device=od.device).expand(mac.shape)
    init = torch.where(torch.isnan(mac), prior, mac)

    D = fit_stain_dictionary(od, mask, regularizer=regularizer,
                             num_iters=num_iters, init=init, low=low)

    swap = D[..., 0, 0] < D[..., 1, 0]
    row0 = torch.where(swap[..., None], D[..., 1, :], D[..., 0, :])
    row1 = torch.where(swap[..., None], D[..., 0, :], D[..., 1, :])
    D = torch.stack([row0, row1], dim=-2)
    D = D / torch.clamp_min(torch.linalg.vector_norm(D, dim=-1, keepdim=True),
                            1e-12)
    return torch.where((tm.count > 0)[..., None, None], D, torch.nan)


_EXTRACTORS = {"macenko": stain_matrix_macenko,
               "vahadane": stain_matrix_vahadane}


def fit(target_rgb, method: str = "macenko", regularizer: float = 0.01,
        low=None, **extractor_kwargs):
    """(stain matrix (..., 2, 3), 99th-percentile concentration per stain
    (..., 2)) of a target image (..., H, W, 3): the reference stainlib's
    ``ExtractiveStainNormalizer.fit``."""
    M = _EXTRACTORS[method](target_rgb, low=low, **extractor_kwargs)
    C = get_concentrations(target_rgb, M, regularizer, low)
    C = C.reshape(C.shape[:-3] + (-1, 2))
    return M, percentile(C, 99.0, axis=-2)
