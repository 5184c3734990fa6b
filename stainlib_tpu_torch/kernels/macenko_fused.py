"""Fused Macenko fit + transform, one CUDA thread block per tile.

Port of the JAX package's ``kernels/macenko_fused.py:541-616``
(``macenko_normalize_planar``, body ``_apply_kernel`` at ``:413-490``):
the whole per-tile pipeline of ``ExtractiveStainNormalizer('macenko')``
(``stainlib/normalization/normalizer.py:39-50`` +
``macenko_stain_extractor.py:7-44``) in one kernel launch per batch.

Kernel source note (``csrc/macenko_fused.cu``):

* Replaces the Pallas TPU kernel ``macenko_normalize_planar`` /
  ``_apply_kernel`` in the JAX package's ``kernels/macenko_fused.py``.
* Bound: work per pixel, not bytes (2 x 196 KB per 256^2 tile). Per
  tile it is a chain of about 25 dependent block-wide reductions
  (moments, angle min/max, the angle and concentration bisection rounds,
  the successor recoveries) with scalar 3x3 work between them. At
  ``fit_stride=2, n_bisect=10`` the passes visit 12.5 tiles' worth of
  pixels, and once two tiles share an SM the time follows that count
  (measured on an H100: 0.78 ms for 132 tiles, 1.34 ms for 256).
* Design: one 512-thread block per tile; every phase is a grid-stride
  pass over the tile's pixels followed by a warp-shuffle + shared-memory
  reduction in a fixed order (no float atomics, so the output is
  bit-reproducible). The tile is re-read from device memory on every pass
  and L2 keeps it close; OD and the luminance terms come from 256-entry
  tables built here, so the kernel takes no ``log`` per pass and sees the
  same OD bits as the plain version.

On a CUDA tensor the wrappers launch the kernel; on a CPU tensor they run
the plain torch version ``macenko_normalize_planar_ref``, which mirrors
``_apply_kernel`` step for step and is the kernel's oracle. ``launches``
counts kernel launches.
"""

from __future__ import annotations

import functools

import torch

from stainlib_tpu_torch.kernels.fused_stain import (
    LANES,
    _check,
    _lasso2,
    _multi_masked_percentile,
    _n_pix,
    _per_tile,
    _scale_and_reconstruct,
    _sum64,
    from_planar,
    to_planar,
)

# Kernel launches since import (or since a caller reset it).
launches = 0

# Degree-6 fit of ((c+0.055)/1.055)^2.4 on [0.04045, 1] (max error 7.4e-6),
# the JAX kernel's mask linearization (macenko_fused.py:54-57), kept so the
# mask follows that kernel's: over all 2^24 colors, one (197, 205, 111)
# lands on the other side of the default threshold, by float32 rounding.
_GAMMA_POLY = (-0.05115230334698914, 0.21590615421296977,
               -0.42192917575406075, 0.7100481714823516,
               0.5132544912131414, 0.0329489372192066,
               0.0009197550259854287)
_LUMA = (0.212671, 0.715160, 0.072169)  # OpenCV RGB->Y row


@functools.lru_cache(maxsize=None)
def _tables(device):
    """(4, 256) float32 lookup tables indexed by a uint8 channel value:
    row 0 the OD ``max(-log(max(c*255, 1)/255), 1e-6)`` with c = u/255,
    rows 1-3 each channel's weighted linear luminance — the f32 expressions
    of ``_od_and_mask`` (``macenko_fused.py:60-85``). Built once per
    device; the kernel and the plain version read the same table."""
    c = torch.arange(256, dtype=torch.float32, device=device) / 255.0
    od = torch.clamp_min(-torch.log(torch.clamp_min(c * 255.0, 1.0) / 255.0),
                         1e-6)
    acc = torch.full_like(c, _GAMMA_POLY[0])
    for coef in _GAMMA_POLY[1:]:
        acc = acc * c + coef
    lin = torch.where(c <= 0.04045, c / 12.92, acc)
    return torch.stack([od] + [w * lin for w in _LUMA]).contiguous()


def _y_threshold(luminosity_threshold: float) -> float:
    """Linear-luminance threshold equivalent to ``L/100 < t`` (L* is
    monotone in Y), in the kernel's f32 arithmetic."""
    t = torch.tensor(luminosity_threshold, dtype=torch.float32)
    lt = 100.0 * t
    if lt > 8.0:
        y_cube = (lt + 16.0) / 116.0
        return (y_cube * y_cube * y_cube).item()
    return (lt / 903.3).item()


def _stride_split(r: int, stride: int):
    """``(bs, step, blocks)`` of the JAX kernel's estimation sample
    (``_stride_rows``, ``macenko_fused.py:377-410``): planar rows
    ``i*step ... i*step+bs-1`` for ``i < blocks``. None means the full tile
    (stride 1, under 64 sample rows, or no 8-aligned split)."""
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
    """Flat pixel indices of the estimation sample, or None (full tile)."""
    split = _stride_split(r, stride)
    if split is None:
        return None
    bs, step, blocks = split
    rows = (torch.arange(blocks, device=device)[:, None] * step
            + torch.arange(bs, device=device)).reshape(-1)
    return (rows[:, None] * LANES
            + torch.arange(LANES, device=device)).reshape(-1)


def _sample_args(n_pix: int, stride: int):
    """The kernels' ``(nblk, blk, stp)``: the estimation sample of
    :func:`_sample_index` in flat pixel units."""
    split = _stride_split(n_pix // LANES, stride)
    bs, step, blocks = (split if split is not None
                        else (n_pix // LANES, n_pix // LANES, 1))
    return blocks, bs * LANES, step * LANES


# ---------------------------------------------------------------------------
# Plain version: _apply_kernel's scalar pieces, batched over tiles.
# ---------------------------------------------------------------------------


def _eigvec3_scalar(a00, a01, a02, a11, a12, a22, lam, eps=1e-12):
    """Unit eigenvector for ``lam`` by the largest cross product of the
    columns of (A - lam I), sign-fixed (``macenko_fused.py:111-158``)."""
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
    """Extreme roots of x^3 - 3x - d by Newton from +-2
    (``macenko_fused.py:161-180``)."""
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
    """Top-2 eigenvector plane from the ten masked OD moments
    (``macenko_fused.py:183-227``); returns (v1x v1y v1z v2x v2y v2z)."""
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
    q = (b00 + b11 + b22) / 3.0
    c00, c11, c22 = b00 - q, b11 - q, b22 - q
    p2 = (c00 * c00 + c11 * c11 + c22 * c22
          + 2.0 * (b01 * b01 + b02 * b02 + b12 * b12)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, eps * eps))
    inv_p = 1.0 / p
    d00, d11, d22 = c00 * inv_p, c11 * inv_p, c22 * inv_p
    d01, d02, d12 = b01 * inv_p, b02 * inv_p, b12 * inv_p
    det = (d00 * (d11 * d22 - d12 * d12)
           - d01 * (d01 * d22 - d12 * d02)
           + d02 * (d01 * d12 - d11 * d02))
    det = torch.clamp(det, -2.0, 2.0)
    x_hi, x_lo = _newton_extreme_roots(det)
    x_mid = -(x_hi + x_lo)  # the trace is zero
    v1 = _eigvec3_scalar(b00, b01, b02, b11, b12, b22, q + p * x_hi)
    v2 = _eigvec3_scalar(b00, b01, b02, b11, b12, b22, q + p * x_mid)
    return v1 + v2


def _pseudo_angle(od0, od1, od2, v):
    """Diamond pseudo-angle of the eigenplane projection, a monotone
    stand-in for atan2 in [0, 4) (``macenko_fused.py:263-282``)."""
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
    stain rows (``macenko_fused.py:297-331``)."""

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
    """Per-tile (B, 8) float32 table: target stain rows, then maxC. Each
    input is a tensor or an array, shared ((2, 3), (2,)) or per tile."""
    return torch.cat([_per_tile(stain_matrix_tgt, 6, batch, device),
                      _per_tile(max_c_target, 2, batch, device)],
                     dim=1).contiguous()


def _od_and_mask(rgb_planar, luminosity_threshold: float):
    """(B, 3, R, 128) uint8 -> OD planes od0, od1, od2 (B, R*128) float32
    and the tissue mask (B, R*128), through the shared tables
    (``_od_and_mask``, ``macenko_fused.py:60-85``)."""
    B = rgb_planar.shape[0]
    lut = _tables(rgb_planar.device)
    x = rgb_planar.reshape(B, 3, -1).to(torch.long)
    mask = (lut[1][x[:, 0]] + lut[2][x[:, 1]] + lut[3][x[:, 2]]
            < _y_threshold(luminosity_threshold))
    return lut[0][x[:, 0]], lut[0][x[:, 1]], lut[0][x[:, 2]], mask


def _macenko_rows(od0, od1, od2, mask, angular_percentile: float,
                  n_bisect: int):
    """The Macenko estimate from a tile's estimation sample: masked
    moments -> eigenplane -> the two masked angular percentiles -> H-first
    row-normalized stain rows (``_apply_kernel``'s phases 1-3, the
    Vahadane kernels' warm start). Returns (n_valid, h, e)."""
    B = od0.shape[0]
    m = mask.to(torch.float32)
    stats = [m.sum(-1)] + [_sum64(m * o) for o in (od0, od1, od2)] + [
        _sum64(m * a * b)
        for a, b in ((od0, od0), (od0, od1), (od0, od2),
                     (od1, od1), (od1, od2), (od2, od2))]
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


def macenko_normalize_planar_ref(
    rgb_planar,
    stain_matrix_tgt,
    max_c_target,
    luminosity_threshold: float = 0.8,
    angular_percentile: float = 99.0,
    q_conc: float = 99.0,
    regularizer: float = 0.01,
    n_bisect: int = 14,
    fit_stride: int = 1,
):
    """Plain torch version of the fused kernel over planar (B, 3, R, 128)
    uint8 tiles, step for step ``_apply_kernel`` (``:413-490``)."""
    B, _, R, L = rgb_planar.shape
    scal = _target_scalars(stain_matrix_tgt, max_c_target, B,
                           rgb_planar.device)
    od0, od1, od2, mask = _od_and_mask(rgb_planar, luminosity_threshold)
    idx = _sample_index(R, fit_stride, rgb_planar.device)

    def sub(t):
        return t if idx is None else t[:, idx]

    _, h, e = _macenko_rows(sub(od0), sub(od1), sub(od2), sub(mask),
                            angular_percentile, n_bisect)
    c1, c2 = _lasso2(od0, od1, od2, h, e, regularizer)
    out = _scale_and_reconstruct(c1, c2, idx, q_conc, n_bisect, scal[:, :6],
                                 scal[:, 6:])
    return out.reshape(B, 3, R, L)


def macenko_normalize_ref(rgb, stain_matrix_tgt, max_c_target, **kw):
    """Plain version over (B, H, W, 3) uint8 tiles."""
    _, H, W, _ = rgb.shape
    out = macenko_normalize_planar_ref(to_planar(rgb), stain_matrix_tgt,
                                       max_c_target, **kw)
    return from_planar(out, H, W)


# ---------------------------------------------------------------------------
# Wrappers: validate, then the CUDA kernel (CUDA tensor) or the plain
# version (CPU tensor).
# ---------------------------------------------------------------------------


def _launch(x, planar: bool, stain_matrix_tgt, max_c_target,
            luminosity_threshold: float = 0.8,
            angular_percentile: float = 99.0, q_conc: float = 99.0,
            regularizer: float = 0.01, n_bisect: int = 14,
            fit_stride: int = 1):
    global launches
    from stainlib_tpu_torch.kernels import _build

    B, dev = x.shape[0], x.device
    n_pix = _n_pix(x, planar)
    scal = _target_scalars(stain_matrix_tgt, max_c_target, B, dev)
    out = torch.empty_like(x)
    pix_stride, ch_stride = (1, n_pix) if planar else (3, 1)
    _build.launch("macenko_normalize_launch", dev, x.data_ptr(),
                  out.data_ptr(), scal.data_ptr(), _tables(dev).data_ptr(),
                  B, n_pix, pix_stride, ch_stride,
                  *_sample_args(n_pix, fit_stride),
                  _y_threshold(luminosity_threshold), regularizer,
                  (100.0 - angular_percentile) / 100.0,
                  angular_percentile / 100.0, q_conc / 100.0,
                  max(n_bisect - 4, 8), n_bisect)
    launches += 1
    return out


def macenko_normalize_planar(
    rgb_planar,
    stain_matrix_tgt,
    max_c_target,
    luminosity_threshold: float = 0.8,
    angular_percentile: float = 99.0,
    q_conc: float = 99.0,
    regularizer: float = 0.01,
    n_bisect: int = 14,
    fit_stride: int = 1,
):
    """Full Macenko fit+transform over planar (B, 3, R, 128) uint8 tiles.

    ``stain_matrix_tgt``: (2, 3) or (B, 2, 3); ``max_c_target``: (2,) or
    (B, 2). ``fit_stride`` restricts the estimation statistics to the
    JAX kernel's stratified row sample; the apply covers every pixel. The
    JAX signature's TPU-only knobs (``interpret``, ``tiles_per_step``,
    ``n_cands``) have no counterpart here.
    """
    _check(rgb_planar, planar=True)
    kw = dict(luminosity_threshold=luminosity_threshold,
              angular_percentile=angular_percentile, q_conc=q_conc,
              regularizer=regularizer, n_bisect=n_bisect,
              fit_stride=fit_stride)
    if rgb_planar.device.type == "cpu":
        return macenko_normalize_planar_ref(rgb_planar, stain_matrix_tgt,
                                            max_c_target, **kw)
    return _launch(rgb_planar, True, stain_matrix_tgt, max_c_target, **kw)


def macenko_normalize(rgb, stain_matrix_tgt, max_c_target, **kw):
    """(B, H, W, 3) uint8 entry point. The kernel reads the interleaved
    bytes directly: the estimation sample is defined on the flat pixel
    index, which is the same in both layouts."""
    _check(rgb, planar=False)
    if rgb.device.type == "cpu":
        return macenko_normalize_ref(rgb, stain_matrix_tgt, max_c_target,
                                     **kw)
    return _launch(rgb, False, stain_matrix_tgt, max_c_target, **kw)
