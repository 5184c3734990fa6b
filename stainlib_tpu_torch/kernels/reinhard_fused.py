"""Fused Reinhard normalization, one thread-block cluster per tile.

Port of the JAX package's ``kernels/reinhard_fused.py:197-239``
(``reinhard_normalize_planar``, body ``_reinhard_kernel`` at ``:140-193``):
``ReinhardStainNormalizer.transform`` (``normalizer.py:70-94``) per tile:
the 90th-percentile brightness standardization, sRGB -> CIELAB, the
uint8-LAB quantize, per-channel mean/std, the affine transfer to the
target, the merge-back floor, CIELAB -> sRGB, in one kernel launch.

Kernel source note (``csrc/reinhard_fused.cu``):

* Replaces the Pallas TPU kernel ``reinhard_normalize_planar`` /
  ``_reinhard_kernel`` in the JAX package's ``kernels/reinhard_fused.py``.
* Bound: per-pixel arithmetic (the cube roots and gamma curves, each a
  ``logf``/``expf`` pair, and IEEE divisions) over three passes of the
  tile: histogram, statistics, apply.
* Design: nearly all of that arithmetic is a function of a byte, so it
  goes into tables. The brightness percentile is a 256-bin shared-memory
  histogram (integer atomics, one per run of equal bytes among a thread's
  8, so its order statistics are exact and do not depend on order)
  instead of the TPU kernel's bisection over the integer grid, which finds
  the same values. Once the percentile ``p`` is known, a per-tile table
  holds the sRGB linearization of every byte after the brightness floor.
  The statistics pass stages each pixel's packed LAB integers as three
  bytes in the tile's own region of the output; after the six sums (in
  double, rounded once) three per-tile 256-entry maps take a staged byte
  to its transferred, merge-back-floored value, and the apply pass is
  three gathers, the 3x3 and the gamma curve. Every pass moves 8 pixels
  per thread and step as three 8-byte vectors. A tile is one cluster of
  :func:`reinhard_plan`'s G blocks of 512 threads, so one image spreads
  over 16 SMs and 256 tiles run one block each; the cluster meets twice
  per tile (the 256 bins; the six sums, folded in rank order), and every
  G gives the same bytes.

On a CUDA tensor the wrappers launch the kernel; on a CPU tensor they run
the plain torch version ``reinhard_normalize_planar_ref``, which follows
``_reinhard_kernel`` step for step. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from stainlib_tpu_torch.kernels.fused_stain import (
    _check,
    _n_pix,
    _per_tile,
    _pointer_arg,
    _sum64,
    from_planar,
    to_planar,
)
from stainlib_tpu_torch.kernels.macenko_fused import CLUSTER_SIZES, sm_count
from stainlib_tpu_torch.ops.fdiv import fdiv
from stainlib_tpu_torch.utils.profiling import kernel_entry

# Kernel launches since import (or since a caller reset it).
launches = 0

_DELTA = 0.008856
_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
_XYZ2RGB = ((3.240479, -1.537150, -0.498535),
            (-0.969256, 1.875992, 0.041556),
            (0.055648, -0.204043, 1.057311))
_WHITE = (0.950456, 1.0, 1.088754)


@functools.lru_cache(maxsize=None)
def _lin_table(device):
    """(256,) float32 sRGB linearization of a byte value c, the kernel's
    ``where(c/255 <= 0.04045, (c/255)/12.92, exp(2.4*log((c/255+0.055)
    /1.055)))`` (``reinhard_fused.py:77-82``). Built on the CPU and copied,
    so the kernel and the plain version read the same table on every
    device."""
    c = torch.arange(256, dtype=torch.float32) * (1.0 / 255.0)
    lin = torch.where(c <= 0.04045, c / 12.92,
                      torch.exp(2.4 * torch.log((c + 0.055) / 1.055)))
    return lin.to(device).contiguous()


@functools.lru_cache(maxsize=None)
def _rank(n_values: int, q: float):
    """np.percentile's rank of the q-th percentile of ``n_values`` values
    in the kernel's float32: (rank_lo, frac, 1 - frac)."""
    rank_f = np.float32(q / 100.0) * np.float32(n_values - 1)
    rank_lo = np.floor(rank_f)
    frac = np.float32(rank_f - rank_lo)
    return float(rank_lo), float(frac), float(np.float32(1.0) - frac)


# ---------------------------------------------------------------------------
# Plain version: _reinhard_kernel step for step, batched over tiles.
# ---------------------------------------------------------------------------


def _percentile_u8(c, q: float):
    """Joint q-th percentile of the three uint8-valued planes ``c``
    (B, 3, N) per tile (``_percentile_u8_multi``, ``:29-72``): 10 rounds of
    count bisection over the integer grid, the snap to it, the successor."""
    B, _, N = c.shape
    rank_lo, frac, omf = _rank(3 * N, q)
    flat = c.reshape(B, -1)
    lo = torch.full((B,), -0.5, dtype=torch.float32, device=c.device)
    hi = torch.full((B,), 255.5, dtype=torch.float32, device=c.device)
    for _ in range(10):
        mid = 0.5 * (lo + hi)
        take = (flat <= mid[:, None]).sum(-1) > rank_lo
        lo, hi = torch.where(take, lo, mid), torch.where(take, mid, hi)
    v_lo = torch.round(hi)
    in_bracket = (flat <= v_lo[:, None]).sum(-1) > rank_lo + 1.0
    succ = torch.where(flat > v_lo[:, None], flat, 256.0).amin(-1)
    v_hi = torch.where(in_bracket, v_lo, torch.clamp_max(succ, 255.0))
    return v_lo * omf + v_hi * frac


def _cbrt(t):
    """exp(log/3) seed and one Newton step (``:89-95``)."""
    third = float(np.float32(1.0 / 3.0))
    y0 = torch.exp(torch.log(torch.clamp_min(t, 1e-12)) * third)
    return (2.0 * y0 + t / (y0 * y0)) * third


def _lab_f(t):
    return torch.where(t > _DELTA, _cbrt(t), 7.787 * t + 16.0 / 116.0)


def _rgb_to_lab_planes(l):
    """Linear RGB planes -> (L, a, b) (``_rgb_to_lab_planes``, ``:75-103``)."""
    x, y, z = (r[0] * l[0] + r[1] * l[1] + r[2] * l[2] for r in _RGB2XYZ)
    x, z = fdiv(x, _WHITE[0]), fdiv(z, _WHITE[2])
    fy = _lab_f(y)
    L = torch.where(y > _DELTA,
                    116.0 * _cbrt(torch.clamp_min(y, _DELTA)) - 16.0,
                    903.3 * y)
    return L, 500.0 * (_lab_f(x) - fy), 200.0 * (fy - _lab_f(z))


def _lab_to_rgb_planes(L, a, b):
    """(L, a, b) -> sRGB planes in [0, 255] (``_lab_to_rgb_planes``,
    ``:106-137``)."""
    fy = fdiv(L + 16.0, 116.0)
    fx = fy + fdiv(a, 500.0)
    fz = fy - fdiv(b, 200.0)

    def f_inv(ft):
        t3 = ft * ft * ft
        return torch.where(t3 > _DELTA, t3, fdiv(ft - 16.0 / 116.0, 7.787))

    y = torch.where(L > 903.3 * _DELTA, fy * fy * fy, fdiv(L, 903.3))
    x = f_inv(fx) * _WHITE[0]
    z = f_inv(fz) * _WHITE[2]
    inv24 = float(np.float32(1.0 / 2.4))

    def compress(c):
        c = torch.clamp_min(c, 0.0)
        srgb = torch.where(
            c <= 0.0031308, c * 12.92,
            1.055 * torch.exp(torch.log(torch.clamp_min(c, 1e-12)) * inv24)
            - 0.055)
        return torch.clamp(srgb, 0.0, 1.0) * 255.0

    return [compress(r[0] * x + r[1] * y + r[2] * z) for r in _XYZ2RGB]


def _quantized_lab(c, p):
    """(B, 3, N) float bytes and the (B,) brightness divisor -> the
    quantized L, a, b planes."""
    bright = torch.floor(torch.clamp(c * 255.0 / p[:, None, None], 0.0,
                                     255.0))
    l = _lin_table(c.device)[bright.to(torch.long)]
    L, a, b = _rgb_to_lab_planes([l[:, 0], l[:, 1], l[:, 2]])
    return (fdiv(torch.clamp(torch.round(L * 2.55), 0.0, 255.0), 2.55),
            torch.clamp(torch.round(a + 128.0), 0.0, 255.0) - 128.0,
            torch.clamp(torch.round(b + 128.0), 0.0, 255.0) - 128.0)


def _reinhard_scalars(target_means, target_stds, batch, device):
    """(B, 8) per-tile table, the TPU kernel's layout: means, stds, pad."""
    return torch.cat([_per_tile(target_means, 3, batch, device),
                      _per_tile(target_stds, 3, batch, device),
                      torch.zeros((batch, 2), dtype=torch.float32,
                                  device=device)], dim=1).contiguous()


def _apply_ref(x, scal, brightness_q: float):
    """(B, 3, N) uint8 -> (B, 3, N) uint8, ``_reinhard_kernel``'s body."""
    c = x.to(torch.float32)
    n = torch.tensor(float(c.shape[-1]), dtype=torch.float32,
                     device=c.device)
    p = torch.clamp_min(_percentile_u8(c, brightness_q), 1e-6)
    lab = _quantized_lab(c, p)
    out = []
    for k, (ch, pack, shift) in enumerate(zip(lab, (2.55, 1.0, 1.0),
                                              (0.0, 128.0, 128.0))):
        mu = _sum64(ch) / n
        sd = torch.sqrt(torch.clamp_min(_sum64(ch * ch) / n - mu * mu,
                                        1e-12))
        t = ((ch - mu[:, None]) * (scal[:, 3 + k] / sd)[:, None]
             + scal[:, k, None])
        # merge_back truncation in the packed domain.
        t = torch.floor(torch.clamp(t * pack + shift, 0.0, 255.0))
        out.append(fdiv(t, 2.55) if k == 0 else t - 128.0)
    rgb = _lab_to_rgb_planes(*out)
    return torch.stack([torch.clamp(torch.round(v), 0.0, 255.0).to(
        torch.uint8) for v in rgb], dim=1)


def reinhard_normalize_planar_ref(rgb_planar, target_means, target_stds,
                                  brightness_q: float = 90.0):
    """Plain torch version of the kernel over planar (B, 3, R, 128) uint8
    tiles."""
    B, _, R, L = rgb_planar.shape
    scal = _reinhard_scalars(target_means, target_stds, B, rgb_planar.device)
    return _apply_ref(rgb_planar.reshape(B, 3, -1), scal,
                      brightness_q).reshape(B, 3, R, L)


def reinhard_normalize_ref(rgb, target_means, target_stds, **kw):
    """Plain version over (B, H, W, 3) uint8 tiles."""
    _, H, W, _ = rgb.shape
    out = reinhard_normalize_planar_ref(to_planar(rgb), target_means,
                                        target_stds, **kw)
    return from_planar(out, H, W)


# ---------------------------------------------------------------------------
# Wrappers: validate, then the CUDA kernel (CUDA tensor) or the plain
# version (CPU tensor).
# ---------------------------------------------------------------------------


# The kernel's blocks hold 512 threads, two to an SM; a block takes 8 pixels
# per thread and step, so a slice under 4096 pixels leaves threads idle.
_BLOCKS_PER_SM = 2
_MIN_SLICE = 4096


class ReinhardPlan(NamedTuple):
    g: int  # blocks per tile, the cluster size
    slice: int  # pixels per block, a multiple of 16; g * slice >= n_pix


def reinhard_plan(batch: int, n_pix: int, slots: int = 264,
                  g: int | None = None) -> ReinhardPlan:
    """The cluster size G of K5 for ``batch`` tiles of ``n_pix`` pixels on a
    card with ``slots`` block slots (SMs x resident blocks; an H100's 132 x
    2 by default): the largest G whose ``batch * G`` blocks still find a
    slot each and whose slices keep 4096 pixels, so 256 tiles run one
    block each and one image spreads over 16 SMs. ``g`` forces G (tests and
    measurements); every G gives the same bytes."""
    if g is None:
        fits = [s for s in CLUSTER_SIZES
                if batch * s <= slots and n_pix >= s * _MIN_SLICE]
        g = fits[-1] if fits else 1
    if g not in CLUSTER_SIZES:
        raise ValueError(f"cluster size {g} is not one of {CLUSTER_SIZES}")
    return ReinhardPlan(g, 16 * -(-n_pix // (16 * g)))


def _block_slots(device) -> int:
    return sm_count(device) * _BLOCKS_PER_SM


@kernel_entry("K5")
def _launch(x, planar: bool, target_means, target_stds,
            brightness_q: float = 90.0, g: int | None = None):
    """K5 on CUDA tiles at :func:`reinhard_plan`'s G (``g`` forces it)."""
    global launches
    from stainlib_tpu_torch.kernels import _build

    B, dev = x.shape[0], x.device
    n_pix = _n_pix(x, planar)
    plan = reinhard_plan(B, n_pix, _block_slots(dev), g)
    means, means_stride = _pointer_arg(target_means, 3, B, dev)
    stds, stds_stride = _pointer_arg(target_stds, 3, B, dev)
    out = torch.empty_like(x)
    _build.launch("reinhard_normalize_launch", dev, x.data_ptr(),
                  out.data_ptr(), means.data_ptr(), means_stride,
                  stds.data_ptr(), stds_stride, _lin_table(dev).data_ptr(),
                  B, n_pix, int(planar), *plan,
                  *_rank(3 * n_pix, brightness_q))
    launches += 1
    return out


def reinhard_normalize_planar(rgb_planar, target_means, target_stds,
                              brightness_q: float = 90.0):
    """Fused Reinhard transform over planar (B, 3, R, 128) uint8 tiles.

    ``target_means`` / ``target_stds``: the (3,) (or per-tile (B, 3)) LAB
    statistics of ``normalization.reinhard.fit``. The JAX signature's
    ``interpret`` has no counterpart here.
    """
    _check(rgb_planar, planar=True)
    if rgb_planar.device.type == "cpu":
        return reinhard_normalize_planar_ref(rgb_planar, target_means,
                                             target_stds, brightness_q)
    return _launch(rgb_planar, True, target_means, target_stds, brightness_q)


def reinhard_normalize(rgb, target_means, target_stds, **kw):
    """(B, H, W, 3) uint8 entry point; the kernel reads the interleaved
    bytes directly."""
    _check(rgb, planar=False)
    if rgb.device.type == "cpu":
        return reinhard_normalize_ref(rgb, target_means, target_stds, **kw)
    return _launch(rgb, False, target_means, target_stds, **kw)
