"""The plain reference of the batched normalize entries: Macenko and
Vahadane fit + transform per tile, and the fixed-matrix normalize.

A frozen copy of the plain torch versions that the port's kernels are held
to (``macenko_normalize_planar_ref``, ``vahadane_normalize_planar_ref`` and
``normalize_with_matrix_ref`` of ``stainlib_tpu_torch.kernels`` with the
helpers they call), plain torch operations only, importing nothing of the
port: the per-tile estimate on the stratified row sample (masked OD moments,
the scalar eigenplane, the pseudo-angle percentiles by count bisection, the
stain rows; for Vahadane the BCD dictionary steps), the exact K=2 lasso on
every pixel, the 99th-percentile rescale and ``255*exp(-C M_target)``.

``low`` is the control's knob (``ops.lowp``): the optical densities, the
lasso's concentrations and the reconstruction's exponent and ``exp`` are
rounded through that dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.reference.ops import fdiv, lowp

LANES = 128
BIG = 3.4e38

# Degree-6 fit of ((c+0.055)/1.055)^2.4 on [0.04045, 1]: the kernels' mask
# linearization.
_GAMMA_POLY = (-0.05115230334698914, 0.21590615421296977,
               -0.42192917575406075, 0.7100481714823516,
               0.5132544912131414, 0.0329489372192066,
               0.0009197550259854287)
_LUMA = (0.212671, 0.715160, 0.072169)  # OpenCV RGB->Y row
_Q_ANGLE = 99.0  # the Vahadane warm start's angular percentile


def to_planar(rgb):
    """(B, H, W, 3) -> (B, 3, H*W/128, 128)."""
    B, H, W, _ = rgb.shape
    n = H * W
    if n % LANES:
        raise ValueError(f"H*W = {H}*{W} is not a multiple of {LANES}")
    return rgb.permute(0, 3, 1, 2).reshape(B, 3, n // LANES, LANES)


def from_planar(planar, h, w):
    return planar.reshape(planar.shape[0], 3, h, w).permute(0, 2, 3, 1)


def _per_tile(x, width, batch, device):
    """A tensor or array, shared or per tile, as (batch, width) float32."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x, np.float32))
    return x.to(device=device, dtype=torch.float32).reshape(
        -1, width).expand(batch, width)


@functools.lru_cache(maxsize=None)
def _tables(device):
    """(4, 256) float32 tables by byte value, built on the CPU: the OD
    ``max(-log(max(c*255, 1)/255), 1e-6)`` and each channel's weighted
    linear luminance."""
    c = torch.arange(256, dtype=torch.float32) / 255.0
    od = torch.clamp_min(-torch.log(torch.clamp_min(c * 255.0, 1.0) / 255.0),
                         1e-6)
    acc = torch.full_like(c, _GAMMA_POLY[0])
    for coef in _GAMMA_POLY[1:]:
        acc = acc * c + coef
    lin = torch.where(c <= 0.04045, c / 12.92, acc)
    return torch.stack([od] + [w * lin for w in _LUMA]).to(device).contiguous()


@functools.lru_cache(maxsize=None)
def _y_threshold(luminosity_threshold: float) -> float:
    """Linear-luminance threshold equivalent to ``L/100 < t``, in float32."""
    t = torch.tensor(luminosity_threshold, dtype=torch.float32)
    lt = 100.0 * t
    if lt > 8.0:
        y_cube = (lt + 16.0) / 116.0
        return (y_cube * y_cube * y_cube).item()
    return (lt / 903.3).item()


def _stride_split(r: int, stride: int):
    """``(bs, step, blocks)`` of the estimation sample: planar rows
    ``i*step ... i*step+bs-1`` for ``i < blocks``; None: the whole tile."""
    if stride <= 1:
        return None
    if r % stride:
        raise ValueError(f"{r} planar rows do not divide by "
                         f"fit_stride={stride}")
    n = r // stride
    if n < 64:
        return None
    blocks = min(max(n // 8, 1), 32)
    while blocks > 1 and (n % blocks or (r // blocks) % 8
                          or (n // blocks) % 8):
        blocks //= 2
    bs, step = n // blocks, r // blocks
    if bs % 8 or step % 8:
        return None
    return bs, step, blocks


def _sample_index(r: int, stride: int, device):
    """Flat pixel indices of the estimation sample, or None (whole tile)."""
    split = _stride_split(r, stride)
    if split is None:
        return None
    bs, step, blocks = split
    rows = (torch.arange(blocks, device=device)[:, None] * step
            + torch.arange(bs, device=device)).reshape(-1)
    return (rows[:, None] * LANES
            + torch.arange(LANES, device=device)).reshape(-1)


def _multi_masked_percentile(searches, n_iters=14):
    """Several ``np.percentile(values[mask], q)`` searches, batched over
    tiles, by count bisection on the rank-floor order statistic with the
    exact successor recovered afterwards. ``searches``: list of
    ``(values (B, N), mask or None, n_valid (B,), q, lo_init, hi_init)``."""
    big = torch.tensor(BIG, dtype=torch.float32)
    ranks, fracs, operands, brackets = [], [], [], []
    cache = {}
    for values, mask, n_valid, q, lo0, hi0 in searches:
        rank_f = (q / 100.0) * torch.clamp_min(n_valid - 1.0, 0.0)
        rank_lo = torch.floor(rank_f)
        ranks.append(rank_lo)
        fracs.append(rank_f - rank_lo)
        if mask is None:
            vm, dlo, dhi = values, lo0, hi0
        else:
            key = (id(values), id(mask))
            if key not in cache:
                vm = torch.where(mask, values, big.to(values.device))
                valid = vm < BIG
                vmin = torch.where(valid, vm, hi0[:, None]).amin(-1)
                vmax = torch.where(valid, vm, lo0[:, None]).amax(-1)
                cache[key] = (vm, vmin, torch.maximum(vmax, vmin))
            vm, dlo, dhi = cache[key]
        operands.append(vm)
        brackets.append((dlo, dhi))

    for _ in range(n_iters):
        for i, (vm, (lo, hi), rank) in enumerate(
                zip(operands, brackets, ranks)):
            mid = 0.5 * (lo + hi)
            cnt = (vm <= mid[:, None]).sum(-1)
            take = cnt > rank
            brackets[i] = (torch.where(take, lo, mid),
                           torch.where(take, mid, hi))

    results = []
    for vm, (_, hi_a), rank, frac in zip(operands, brackets, ranks, fracs):
        cnt_hi = (vm <= hi_a[:, None]).sum(-1)
        succ = torch.where(vm > hi_a[:, None], vm,
                           big.to(vm.device)).amin(-1)
        v_b = torch.where(cnt_hi > rank + 1.0, hi_a, succ)
        results.append(hi_a * (1.0 - frac) + v_b * frac)
    return results


def _sum64(x):
    """Sum over the last axis in float64, rounded once to float32."""
    return x.double().sum(-1).float()


def _lasso2(od0, od1, od2, h, e, lam, low=None):
    """Exact non-negative K=2 lasso per pixel against per-tile rows
    ``h``/``e`` (3 lists of (B,))."""
    g11 = h[0] * h[0] + h[1] * h[1] + h[2] * h[2]
    g22 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2]
    g12 = h[0] * e[0] + h[1] * e[1] + h[2] * e[2]
    det = torch.clamp_min(g11 * g22 - g12 * g12, 1e-12)[:, None]
    h = [x[:, None] for x in h]
    e = [x[:, None] for x in e]
    g11, g22, g12 = g11[:, None], g22[:, None], g12[:, None]
    bb1 = od0 * h[0] + od1 * h[1] + od2 * h[2] - lam
    bb2 = od0 * e[0] + od1 * e[1] + od2 * e[2] - lam
    c1_full = (g22 * bb1 - g12 * bb2) / det
    c2_full = (g11 * bb2 - g12 * bb1) / det
    ok_full = (c1_full >= 0.0) & (c2_full >= 0.0)
    c1_only = torch.clamp_min(bb1, 0.0) / g11
    ok_1 = (bb1 >= 0.0) & (g12 * c1_only - bb2 >= 0.0)
    c2_only = torch.clamp_min(bb2, 0.0) / g22
    ok_2 = (bb2 >= 0.0) & (g12 * c2_only - bb1 >= 0.0)
    c1 = torch.where(ok_full, c1_full, torch.where(ok_1, c1_only, 0.0))
    c2 = torch.where(ok_full, c2_full,
                     torch.where(~ok_1 & ok_2, c2_only, 0.0))
    return lowp(c1, low), lowp(c2, low)


def _conc_maxc(c1, c2, idx, q, n_iters):
    """The two q-th percentile concentrations over the pixels ``idx``
    (None: all), each bracket [0, max]."""
    c1f, c2f = (c1, c2) if idx is None else (c1[:, idx], c2[:, idx])
    B = c1.shape[0]
    n_fit = torch.full((B,), float(c1f.shape[1]), dtype=torch.float32,
                       device=c1.device)
    zero = torch.zeros_like(n_fit)
    return _multi_masked_percentile(
        [(c1f, None, n_fit, q, zero, c1f.amax(-1)),
         (c2f, None, n_fit, q, zero, c2f.amax(-1))], n_iters=n_iters)


def _reconstruct_u8(c1s, c2s, tgt, low=None):
    """``255 * exp(-C M_tgt)`` of (B, N) concentrations through the target
    rows ``tgt`` (B, 6), clipped and truncated to (B, 3, N) uint8."""
    out = []
    for ch in range(3):
        arg = lowp(-(c1s * tgt[:, ch, None] + c2s * tgt[:, 3 + ch, None]),
                   low)
        val = torch.clamp(255.0 * lowp(torch.exp(arg), low), 0.0, 255.0)
        out.append(val.to(torch.int32).to(torch.uint8))
    return torch.stack(out, dim=1)


def _scale_and_reconstruct(c1, c2, idx, q, n_iters, tgt, max_c, low=None):
    maxc1, maxc2 = _conc_maxc(c1, c2, idx, q, n_iters)
    c1s = c1 * (max_c[:, 0] / torch.clamp_min(maxc1, 1e-8))[:, None]
    c2s = c2 * (max_c[:, 1] / torch.clamp_min(maxc2, 1e-8))[:, None]
    return _reconstruct_u8(c1s, c2s, tgt, low)


# ---------------------------------------------------------------------------
# The Macenko estimate's scalar pieces, batched over tiles.
# ---------------------------------------------------------------------------

def _eigvec3_scalar(a00, a01, a02, a11, a12, a22, lam, eps=1e-12):
    """Unit eigenvector for ``lam`` by the largest cross product of the
    columns of (A - lam I), sign-fixed."""
    m00, m11, m22 = a00 - lam, a11 - lam, a22 - lam

    def cross(u, v):
        return (u[1] * v[2] - u[2] * v[1],
                u[2] * v[0] - u[0] * v[2],
                u[0] * v[1] - u[1] * v[0])

    def nrm2(u):
        return u[0] * u[0] + u[1] * u[1] + u[2] * u[2]

    c0, c1, c2 = (m00, a01, a02), (a01, m11, a12), (a02, a12, m22)
    x01, x02, x12 = cross(c0, c1), cross(c0, c2), cross(c1, c2)
    n01, n02, n12 = nrm2(x01), nrm2(x02), nrm2(x12)
    best12 = (n12 >= n01) & (n12 >= n02)
    best02 = (~best12) & (n02 >= n01)
    v = [torch.where(best12, x12[i], torch.where(best02, x02[i], x01[i]))
         for i in range(3)]
    nv = torch.sqrt(nrm2(v))
    ok = nv > eps
    inv = 1.0 / torch.clamp_min(nv, eps)
    v = [torch.where(ok, v[0] * inv, 1.0), torch.where(ok, v[1] * inv, 0.0),
         torch.where(ok, v[2] * inv, 0.0)]
    av = [x.abs() for x in v]
    lead = torch.where((av[0] >= av[1]) & (av[0] >= av[2]), v[0],
                       torch.where(av[1] >= av[2], v[1], v[2]))
    s = torch.where(lead < 0.0, -1.0, 1.0)
    v = [x * s for x in v]
    s = torch.where(v[0] < 0.0, -1.0, 1.0)
    return tuple(x * s for x in v)


def _newton_extreme_roots(d, n_iters: int = 12):
    """Extreme roots of x^3 - 3x - d by Newton from +-2."""
    xh = torch.full_like(d, 2.0)
    xl = torch.full_like(d, -2.0)
    for _ in range(n_iters):
        fh = (xh * xh - 3.0) * xh - d
        fph = 3.0 * xh * xh - 3.0
        fl = (xl * xl - 3.0) * xl - d
        fpl = 3.0 * xl * xl - 3.0
        xh = xh - fh / torch.clamp_min(fph, 1e-12)
        xl = xl - fl / torch.clamp_min(fpl, 1e-12)
    return xh, xl


def _eigenplane_scalars(stats, eps=1e-12):
    """Top-2 eigenvector plane from the ten masked OD moments; returns
    (v1x v1y v1z v2x v2y v2z)."""
    n, s0, s1, s2, q00, q01, q02, q11, q12, q22 = stats
    sn = torch.clamp_min(n, 1.0)
    m0, m1, m2 = s0 / sn, s1 / sn, s2 / sn
    denom = 1.0 / torch.clamp_min(n - 1.0, 1.0)
    a00 = (q00 - n * m0 * m0) * denom
    a01 = (q01 - n * m0 * m1) * denom
    a02 = (q02 - n * m0 * m2) * denom
    a11 = (q11 - n * m1 * m1) * denom
    a12 = (q12 - n * m1 * m2) * denom
    a22 = (q22 - n * m2 * m2) * denom

    mx = torch.maximum
    scale = mx(mx(mx(a00.abs(), a01.abs()), mx(a02.abs(), a11.abs())),
               mx(mx(a12.abs(), a22.abs()), torch.full_like(a00, eps)))
    b00, b01, b02 = a00 / scale, a01 / scale, a02 / scale
    b11, b12, b22 = a11 / scale, a12 / scale, a22 / scale
    q = fdiv(b00 + b11 + b22, 3.0)
    c00, c11, c22 = b00 - q, b11 - q, b22 - q
    p2 = fdiv(c00 * c00 + c11 * c11 + c22 * c22
              + 2.0 * (b01 * b01 + b02 * b02 + b12 * b12), 6.0)
    p = torch.sqrt(torch.clamp_min(p2, eps * eps))
    inv_p = 1.0 / p
    d00, d11, d22 = c00 * inv_p, c11 * inv_p, c22 * inv_p
    d01, d02, d12 = b01 * inv_p, b02 * inv_p, b12 * inv_p
    det = (d00 * (d11 * d22 - d12 * d12)
           - d01 * (d01 * d22 - d12 * d02)
           + d02 * (d01 * d12 - d11 * d02))
    det = torch.clamp(det, -2.0, 2.0)
    x_hi, x_lo = _newton_extreme_roots(det)
    x_mid = -(x_hi + x_lo)
    v1 = _eigvec3_scalar(b00, b01, b02, b11, b12, b22, q + p * x_hi)
    v2 = _eigvec3_scalar(b00, b01, b02, b11, b12, b22, q + p * x_mid)
    return v1 + v2


def _pseudo_angle(od0, od1, od2, v):
    """Diamond pseudo-angle of the eigenplane projection, in [0, 4)."""
    v = [x[:, None] for x in v]
    t1 = od0 * v[0] + od1 * v[1] + od2 * v[2]
    t2 = od0 * v[3] + od1 * v[4] + od2 * v[5]
    eps = 1e-30
    p = torch.where(
        t2 >= 0.0,
        torch.where(t1 >= 0.0, t2 / (t1 + t2 + eps),
                    1.0 - t1 / (t2 - t1 + eps)),
        torch.where(t1 < 0.0, 2.0 - t2 / (-t1 - t2 + eps),
                    3.0 + t1 / (t1 - t2 + eps)),
    )
    m = p + 2.0
    return torch.where(m >= 4.0, m - 4.0, m)


def _stain_rows_from_bounds(v, min_m, max_m):
    """Pseudo-angle bounds -> unit directions -> H-first row-normalized
    stain rows."""

    def unit_dir(m):
        pp = m + 2.0
        pp = torch.where(pp >= 4.0, pp - 4.0, pp)
        x = torch.where(pp < 2.0, 1.0 - pp, pp - 3.0)
        y = torch.where(pp < 1.0, pp,
                        torch.where(pp < 3.0, 2.0 - pp, pp - 4.0))
        inv = 1.0 / torch.sqrt(x * x + y * y + 1e-12)
        return x * inv, y * inv

    c_min, s_min = unit_dir(min_m)
    c_max, s_max = unit_dir(max_m)
    a = [v[i] * c_min + v[3 + i] * s_min for i in range(3)]
    b = [v[i] * c_max + v[3 + i] * s_max for i in range(3)]
    a_first = a[0] > b[0]
    h = [torch.where(a_first, a[i], b[i]) for i in range(3)]
    e = [torch.where(a_first, b[i], a[i]) for i in range(3)]
    hn = 1.0 / torch.sqrt(h[0] * h[0] + h[1] * h[1] + h[2] * h[2] + 1e-12)
    en = 1.0 / torch.sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2] + 1e-12)
    return [x * hn for x in h], [x * en for x in e]


def _target_scalars(stain_matrix_tgt, max_c_target, batch, device):
    """Per-tile (B, 8) float32: target stain rows, then maxC."""
    return torch.cat([_per_tile(stain_matrix_tgt, 6, batch, device),
                      _per_tile(max_c_target, 2, batch, device)],
                     dim=1).contiguous()


def _od_and_mask(rgb_planar, luminosity_threshold: float, low=None):
    """(B, 3, R, 128) uint8 -> OD planes (B, R*128) and the tissue mask."""
    B = rgb_planar.shape[0]
    lut = _tables(rgb_planar.device)
    x = rgb_planar.reshape(B, 3, -1).to(torch.long)
    mask = (lut[1][x[:, 0]] + lut[2][x[:, 1]] + lut[3][x[:, 2]]
            < _y_threshold(luminosity_threshold))
    od = lowp(lut[0], low)
    return od[x[:, 0]], od[x[:, 1]], od[x[:, 2]], mask


def _masked_moments(od0, od1, od2, mask):
    """The ten masked OD moments as (B,) tensors, sums in float64."""
    m = mask.to(torch.float32)
    return [m.sum(-1)] + [_sum64(m * o) for o in (od0, od1, od2)] + [
        _sum64(m * a * b)
        for a, b in ((od0, od0), (od0, od1), (od0, od2),
                     (od1, od1), (od1, od2), (od2, od2))]


def _macenko_rows(od0, od1, od2, mask, angular_percentile: float,
                  n_bisect: int):
    """Masked moments -> eigenplane -> the two masked angular percentiles
    -> H-first row-normalized stain rows. Returns (n_valid, h, e)."""
    B = od0.shape[0]
    stats = _masked_moments(od0, od1, od2, mask)
    v = _eigenplane_scalars(stats)
    angle = _pseudo_angle(od0, od1, od2, v)
    zero = torch.zeros(B, dtype=torch.float32, device=od0.device)
    four = torch.full((B,), 4.0, dtype=torch.float32, device=od0.device)
    min_m, max_m = _multi_masked_percentile(
        [(angle, mask, stats[0], 100.0 - angular_percentile, zero, four),
         (angle, mask, stats[0], angular_percentile, zero, four)],
        n_iters=max(n_bisect - 4, 8))
    h, e = _stain_rows_from_bounds(v, min_m, max_m)
    return stats[0], h, e


# ---------------------------------------------------------------------------
# The entries.
# ---------------------------------------------------------------------------

def macenko_normalize_planar(rgb_planar, stain_matrix_tgt, max_c_target,
                             luminosity_threshold: float = 0.8,
                             angular_percentile: float = 99.0,
                             q_conc: float = 99.0, regularizer: float = 0.01,
                             n_bisect: int = 14, fit_stride: int = 1,
                             low=None):
    """Macenko fit + transform per tile over planar uint8 tiles."""
    B, _, R, L = rgb_planar.shape
    scal = _target_scalars(stain_matrix_tgt, max_c_target, B,
                           rgb_planar.device)
    od0, od1, od2, mask = _od_and_mask(rgb_planar, luminosity_threshold, low)
    idx = _sample_index(R, fit_stride, rgb_planar.device)

    def sub(t):
        return t if idx is None else t[:, idx]

    _, h, e = _macenko_rows(sub(od0), sub(od1), sub(od2), sub(mask),
                            angular_percentile, n_bisect)
    c1, c2 = _lasso2(od0, od1, od2, h, e, regularizer, low)
    out = _scale_and_reconstruct(c1, c2, idx, q_conc, n_bisect, scal[:, :6],
                                 scal[:, 6:], low)
    return out.reshape(B, 3, R, L)


def _bcd_iteration(D, od0, od1, od2, m, regularizer: float, low=None):
    """One BCD alternation: exact lasso codes of every sample pixel, the
    nine masked sums, two row sweeps. ``D``: 6 (B,) tensors."""
    a1, a2 = _lasso2(od0, od1, od2, D[:3], D[3:], regularizer, low)
    a1m = a1 * m
    a2m = a2 * m
    c11 = _sum64(a1m * a1)
    c12 = _sum64(a1m * a2)
    c22 = _sum64(a2m * a2)
    b1 = [_sum64(a1m * o) for o in (od0, od1, od2)]
    b2 = [_sum64(a2m * o) for o in (od0, od1, od2)]

    def step(row, other, cjj_raw, b, first):
        cjj = torch.clamp_min(cjj_raw, 1e-8)
        u = [torch.clamp_min(
            row[i] + (b[i] - (c11 * row[i] + c12 * other[i]) if first
                      else b[i] - (c12 * other[i] + c22 * row[i])) / cjj,
            0.0) for i in range(3)]
        s = 1.0 / torch.clamp_min(
            torch.sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2]), 1.0)
        dead = (u[0] + u[1] + u[2]) <= 0.0
        return [torch.where(dead, row[i], u[i] * s) for i in range(3)]

    h, e = list(D[:3]), list(D[3:])
    for _sweep in range(2):
        h = step(h, e, c11, b1, True)
        e = step(e, h, c22, b2, False)
    return h + e


def _finalize_rows(D):
    """H first by the unnormalized red components, then each row over
    ``max(|row|, 1e-12)``; returns (h, e)."""
    swap = D[0] < D[3]
    h = [torch.where(swap, D[3 + i], D[i]) for i in range(3)]
    e = [torch.where(swap, D[i], D[3 + i]) for i in range(3)]
    hn = 1.0 / torch.clamp_min(
        torch.sqrt(h[0] * h[0] + h[1] * h[1] + h[2] * h[2]), 1e-12)
    en = 1.0 / torch.clamp_min(
        torch.sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]), 1e-12)
    return [x * hn for x in h], [x * en for x in e]


def vahadane_normalize_planar(rgb_planar, stain_matrix_tgt, max_c_target,
                              regularizer_fit: float = 0.1,
                              regularizer: float = 0.01, num_iters: int = 12,
                              luminosity_threshold: float = 0.8,
                              n_bisect: int = 14, q_conc: float = 99.0,
                              fit_stride: int = 1, low=None):
    """Vahadane fit + transform per tile over planar uint8 tiles: the
    Macenko warm start, ``num_iters`` BCD steps on the sample, the apply."""
    B, _, R, L = rgb_planar.shape
    scal = _target_scalars(stain_matrix_tgt, max_c_target, B,
                           rgb_planar.device)
    od0, od1, od2, mask = _od_and_mask(rgb_planar, luminosity_threshold, low)
    idx = _sample_index(R, fit_stride, rgb_planar.device)

    def sub(t):
        return t if idx is None else t[:, idx]

    od0f, od1f, od2f, maskf = sub(od0), sub(od1), sub(od2), sub(mask)
    _, h, e = _macenko_rows(od0f, od1f, od2f, maskf, _Q_ANGLE, n_bisect)
    D = h + e
    m = maskf.to(torch.float32)
    for _ in range(num_iters):
        D = _bcd_iteration(D, od0f, od1f, od2f, m, regularizer_fit, low)
    h, e = _finalize_rows(D)
    c1, c2 = _lasso2(od0, od1, od2, h, e, regularizer, low)
    out = _scale_and_reconstruct(c1, c2, idx, q_conc, n_bisect, scal[:, :6],
                                 scal[:, 6:], low)
    return out.reshape(B, 3, R, L)


def macenko_normalize(rgb, stain_matrix_tgt, max_c_target, **kw):
    """(B, H, W, 3) uint8 tiles in and out."""
    _, H, W, _ = rgb.shape
    return from_planar(macenko_normalize_planar(
        to_planar(rgb), stain_matrix_tgt, max_c_target, **kw), H, W)


def vahadane_normalize(rgb, stain_matrix_tgt, max_c_target, **kw):
    """(B, H, W, 3) uint8 tiles in and out."""
    _, H, W, _ = rgb.shape
    return from_planar(vahadane_normalize_planar(
        to_planar(rgb), stain_matrix_tgt, max_c_target, **kw), H, W)


def normalize_with_matrix(rgb, stain_matrix_src, max_c_src, stain_matrix_tgt,
                          max_c_tgt, regularizer: float = 0.01, low=None):
    """Fixed-matrix normalize of (B, H, W, 3) uint8 images: the exact lasso
    against the source rows, the rescale ``max_c_tgt / max(max_c_src,
    1e-8)``, the reconstruction through the target rows."""
    B, H, W, _ = rgb.shape
    dev = rgb.device
    mcs = _per_tile(max_c_src, 2, B, dev)
    mct = _per_tile(max_c_tgt, 2, B, dev)
    src = _per_tile(stain_matrix_src, 6, B, dev)
    tgt = _per_tile(stain_matrix_tgt, 6, B, dev).contiguous()
    scale = mct / torch.clamp_min(mcs, 1e-8)
    lut = lowp(_tables(dev)[0], low)
    x = rgb.reshape(B, H * W, 3).transpose(1, 2).to(torch.long)
    c1, c2 = _lasso2(lut[x[:, 0]], lut[x[:, 1]], lut[x[:, 2]],
                     list(src[:, 0:3].T), list(src[:, 3:6].T), regularizer,
                     low)
    out = _reconstruct_u8(c1 * scale[:, 0, None], c2 * scale[:, 1, None],
                          tgt, low)
    return out.transpose(1, 2).reshape(B, H, W, 3)
