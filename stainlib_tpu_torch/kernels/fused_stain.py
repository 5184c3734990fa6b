"""Planar tile layout, the plain percentile and apply pieces, and the fused
fixed-matrix normalize kernel.

Port of the JAX package's ``kernels/fused_stain.py``: the layout helpers
``to_planar`` / ``from_planar`` (``:281-292``); as plain torch, the
``n_cands=1`` path of ``_multi_masked_percentile`` (``:43-146``) and the
lasso and reconstruction that the fused stain kernels share; and
``fused_normalize_planar`` (``:219-278``, body ``_normalize_kernel``
``:177-215``): normalize every pixel of a tile against a given per-tile
source stain matrix, with the 99th-percentile concentrations taken over
the tile. The search answers ``np.percentile``'s linear rule
(``stainlib/normalization/normalizer.py:36,46``).

Kernel source note (``csrc/fused_stain.cu``):

* Replaces the Pallas TPU kernel ``fused_normalize_planar`` /
  ``_normalize_kernel`` in the JAX package's ``kernels/fused_stain.py``.
* Bound: work per pixel and the chain of dependent reductions, not bytes:
  a lasso per pixel, 14 bisection rounds over two concentrations per
  pixel, three ``expf`` per pixel.
* Design: K1's (``macenko_fused.py``): one thread-block cluster of
  ``macenko_fused.cluster_plan``'s G blocks of 512 threads per tile (16
  for one image, two per tile staged in device memory for 256 tiles). The
  one pass over device memory stages every pixel's two concentrations, so
  the bisection bins staged values into leaf histograms, up to eight
  rounds and the successor per reduction (three reductions in all), and
  the apply, since the sample is the whole tile, rescales and
  reconstructs each pixel from its staged concentrations. A shared
  256-entry OD table holds ``_od_lasso``'s expression, not
  ``_od_and_mask``'s. The per-tile source rows, target rows and maxC
  arrive by pointer and stride (``_pointer_arg``), so the wrapper builds
  no table. Reductions fold in a fixed order, so the output is
  bit-reproducible and the same at every G.

On a CUDA tensor ``fused_normalize_planar`` launches the kernel; on a CPU
tensor it runs the plain version ``fused_normalize_planar_ref``.
``launches`` counts kernel launches, ``reductions_per_tile`` the chain
length of the last.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stainlib_tpu_torch.utils.profiling import kernel_entry

LANES = 128
BIG = 3.4e38
_ITERS = 14  # K9's bisection rounds per concentration search

# Kernel launches since import (or since a caller reset it).
launches = 0
# Dependent cluster reductions per tile of the last launch
# (``macenko_fused.chain_length``).
reductions_per_tile = 0


def to_planar(rgb):
    """(B, H, W, 3) -> (B, 3, H*W/128, 128) planar lane-aligned layout."""
    B, H, W, _ = rgb.shape
    n = H * W
    if n % LANES:
        raise ValueError(f"H*W = {H}*{W} is not a multiple of {LANES}")
    return rgb.permute(0, 3, 1, 2).reshape(B, 3, n // LANES, LANES)


def from_planar(planar, h, w):
    """Inverse of :func:`to_planar`."""
    return planar.reshape(planar.shape[0], 3, h, w).permute(0, 2, 3, 1)


def blockify(rgb, block: int, pad_value: int = 255):
    """(B, H, W, 3) -> (B * nh * nw, block, block, 3) spatial blocks, the
    field padded with ``pad_value`` (white: zero stain concentration) up to
    a block multiple (``fused_stain.py:295-310``); :func:`unblockify` crops
    it back off."""
    B, H, W, C = rgb.shape
    hp, wp = -H % block, -W % block
    if hp or wp:
        padded = rgb.new_full((B, H + hp, W + wp, C), pad_value)
        padded[:, :H, :W] = rgb
        rgb = padded
    nh, nw = (H + hp) // block, (W + wp) // block
    blocks = rgb.reshape(B, nh, block, nw, block, C).permute(0, 1, 3, 2, 4, 5)
    return blocks.reshape(B * nh * nw, block, block, C), (nh, nw)


def unblockify(blocks, grid, h: int, w: int):
    """Inverse of :func:`blockify`: reassemble and crop to (B, h, w, 3)."""
    nh, nw = grid
    n, block, _, C = blocks.shape
    x = blocks.reshape(n // (nh * nw), nh, nw, block, block, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(x.shape[0], nh * block, nw * block, C)[:, :h, :w]


def _check(x, planar: bool, lanes: bool = True):
    """Raise unless ``x`` is uint8 tiles a kernel wrapper takes. ``lanes``:
    interleaved tiles must hold a multiple of 128 pixels."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.uint8:
        raise TypeError("expected a uint8 torch.Tensor")
    if planar:
        ok = x.ndim == 4 and x.shape[1] == 3 and x.shape[3] == LANES
        want = "(B, 3, R, 128)"
    else:
        ok = (x.ndim == 4 and x.shape[3] == 3
              and (not lanes or (x.shape[1] * x.shape[2]) % LANES == 0))
        want = ("(B, H, W, 3) with H*W a multiple of 128" if lanes
                else "(B, H, W, 3)")
    if not ok:
        raise ValueError(f"expected {want} tiles, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("the CUDA kernel takes contiguous tiles")


def _n_pix(x, planar: bool) -> int:
    return x.shape[2] * x.shape[3] if planar else x.shape[1] * x.shape[2]


def _per_tile(x, width, batch, device):
    """A tensor or array, shared or per tile, as (batch, width) float32."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x, np.float32))
    return x.to(device=device, dtype=torch.float32).reshape(
        -1, width).expand(batch, width)


def _pointer_arg(x, width: int, batch: int, device):
    """A kernel's per-image argument passed by pointer: ``(tensor, stride)``,
    a float32 contiguous tensor on ``device`` holding ``width`` values shared
    by all images (stride 0) or ``width`` per image (stride ``width``). A
    tensor that already is one is passed as it is; anything else (an array,
    a list, a CPU tensor, another dtype or layout) is converted once."""
    ready = (isinstance(x, torch.Tensor) and x.dtype == torch.float32
             and x.device == device and x.is_contiguous())
    if not ready:
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x, np.float32))
        x = x.to(device=device, dtype=torch.float32).contiguous()
    if x.numel() == width:
        return x, 0
    if x.numel() == batch * width:
        return x, width
    raise ValueError(f"expected {width} values, shared or for each of "
                     f"{batch} images, got shape {tuple(x.shape)}")


def _multi_masked_percentile(searches, n_iters=14):
    """Several ``np.percentile(values[mask], q)`` searches, batched over
    tiles, by count bisection on the rank-floor order statistic with the
    exact successor recovered afterwards.

    ``searches``: list of ``(values (B, N), mask (B, N) bool or None,
    n_valid (B,), q, lo_init (B,), hi_init (B,))``. A masked search seeds
    its bracket from the masked data's own min/max (shared by searches on
    the same operand); an unmasked one starts from ``[lo_init, hi_init]``.
    Returns one (B,) percentile per search.
    """
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
            take = cnt > rank  # v_(k) <= mid
            brackets[i] = (torch.where(take, lo, mid),
                           torch.where(take, mid, hi))

    results = []
    for vm, (_, hi_a), rank, frac in zip(operands, brackets, ranks, fracs):
        # v_(k) lies in (lo, hi_a]; v_(k+1) is in the same bracket iff
        # count(<= hi_a) exceeds rank+1, else it is the smallest value
        # above the bracket.
        cnt_hi = (vm <= hi_a[:, None]).sum(-1)
        succ = torch.where(vm > hi_a[:, None], vm,
                           big.to(vm.device)).amin(-1)
        v_b = torch.where(cnt_hi > rank + 1.0, hi_a, succ)
        results.append(hi_a * (1.0 - frac) + v_b * frac)
    return results


def _sum64(x):
    """Sum over the last axis in float64, rounded once to float32. The
    plain versions and the kernels sum the pixel terms that feed a stain
    estimate (moments, BCD statistics) this way, so both round to the same
    float32 whatever the order of the sum; a float32 sum in another order
    can flip a bisection decision downstream."""
    return x.double().sum(-1).float()


def _lasso2(od0, od1, od2, h, e, lam):
    """Exact non-negative K=2 lasso per pixel against per-tile rows
    ``h``/``e`` (3 lists of (B,)); the JAX package's
    ``macenko_fused.py:354-374`` and ``fused_stain.py:158-174``."""
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
    return c1, c2


def _conc_maxc(c1, c2, idx, q, n_iters):
    """The two q-th percentile concentrations over the pixels ``idx``
    (None: all), unmasked, each bracket [0, max]: (B,) each."""
    c1f, c2f = (c1, c2) if idx is None else (c1[:, idx], c2[:, idx])
    B = c1.shape[0]
    n_fit = torch.full((B,), float(c1f.shape[1]), dtype=torch.float32,
                       device=c1.device)
    zero = torch.zeros_like(n_fit)
    return _multi_masked_percentile(
        [(c1f, None, n_fit, q, zero, c1f.amax(-1)),
         (c2f, None, n_fit, q, zero, c2f.amax(-1))], n_iters=n_iters)


def _reconstruct_u8(c1s, c2s, tgt):
    """Rescaled (B, N) concentrations through the target rows ``tgt``
    (B, 6): ``255 * exp(-C M_tgt)``, clipped and truncated to (B, 3, N)
    uint8."""
    out = [torch.clamp(255.0 * torch.exp(-(c1s * tgt[:, ch, None]
                                           + c2s * tgt[:, 3 + ch, None])),
                       0.0, 255.0).to(torch.int32).to(torch.uint8)
           for ch in range(3)]
    return torch.stack(out, dim=1)


def _scale_and_reconstruct(c1, c2, idx, q, n_iters, tgt, max_c):
    """The fused kernels' last phases: :func:`_conc_maxc`, rescale by
    ``max_c`` (B, 2) over it, :func:`_reconstruct_u8`. (B, N)
    concentrations in, (B, 3, N) uint8 out."""
    maxc1, maxc2 = _conc_maxc(c1, c2, idx, q, n_iters)
    c1s = c1 * (max_c[:, 0] / torch.clamp_min(maxc1, 1e-8))[:, None]
    c2s = c2 * (max_c[:, 1] / torch.clamp_min(maxc2, 1e-8))[:, None]
    return _reconstruct_u8(c1s, c2s, tgt)


# ---------------------------------------------------------------------------
# K9: normalize against given per-tile source stain matrices.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _od_lasso_table(device):
    """(256,) float32 OD of a byte as ``_od_lasso`` computes it
    (``fused_stain.py:154-156``): ``max(-log(max(u, 1) * (1/255)), 1e-6)``.
    In float32 this differs from ``_od_and_mask``'s OD (the Macenko and
    Vahadane kernels' tables) in the last bit for 100 of the 256 values.
    Built on the CPU and copied, once per device."""
    u = torch.arange(256, dtype=torch.float32)
    return torch.clamp_min(-torch.log(torch.clamp_min(u, 1.0) * (1.0 / 255.0)),
                           1e-6).to(device).contiguous()


def _od_lasso(rgb_planar, h, e, lam):
    """Plain ``_od_lasso`` (``fused_stain.py:149-174``): (B, 3, R, 128)
    uint8 -> OD -> exact lasso against the per-tile rows -> (c1, c2), each
    (B, R*128)."""
    B = rgb_planar.shape[0]
    x = rgb_planar.reshape(B, 3, -1).to(torch.long)
    lut = _od_lasso_table(rgb_planar.device)
    return _lasso2(lut[x[:, 0]], lut[x[:, 1]], lut[x[:, 2]], h, e, lam)


def _normalize_scalars(stain_matrix_src, stain_matrix_tgt, max_c_target,
                       regularizer, batch, device):
    """The plain version's (B, 16) per-tile table, the TPU kernel's layout:
    source rows, target rows, maxC_target, regularizer, pad."""
    return torch.cat([
        _per_tile(stain_matrix_src, 6, batch, device),
        _per_tile(stain_matrix_tgt, 6, batch, device),
        _per_tile(max_c_target, 2, batch, device),
        torch.full((batch, 1), regularizer, dtype=torch.float32,
                   device=device),
        torch.zeros((batch, 1), dtype=torch.float32, device=device),
    ], dim=1).contiguous()


def fused_normalize_planar_ref(rgb_planar, stain_matrix_src, stain_matrix_tgt,
                               max_c_target, q: float = 99.0,
                               regularizer: float = 0.01):
    """Plain torch version of the kernel over planar (B, 3, R, 128) uint8
    tiles, step for step ``_normalize_kernel`` (``:177-215``)."""
    B, _, R, L = rgb_planar.shape
    scal = _normalize_scalars(stain_matrix_src, stain_matrix_tgt,
                              max_c_target, regularizer, B,
                              rgb_planar.device)
    c1, c2 = _od_lasso(rgb_planar, list(scal[:, 0:3].T),
                       list(scal[:, 3:6].T), scal[:, 14, None])
    out = _scale_and_reconstruct(c1, c2, None, q, _ITERS, scal[:, 6:12],
                                 scal[:, 12:14])
    return out.reshape(B, 3, R, L)


def fused_normalize_ref(rgb, stain_matrix_src, stain_matrix_tgt,
                        max_c_target, **kw):
    """Plain version over (B, H, W, 3) uint8 tiles."""
    _, H, W, _ = rgb.shape
    out = fused_normalize_planar_ref(to_planar(rgb), stain_matrix_src,
                                     stain_matrix_tgt, max_c_target, **kw)
    return from_planar(out, H, W)


@kernel_entry("K9")
def _launch(x, planar: bool, stain_matrix_src, stain_matrix_tgt,
            max_c_target, q: float = 99.0, regularizer: float = 0.01,
            g: int | None = None):
    """K9 on CUDA tiles at ``macenko_fused.cluster_plan``'s G (``g`` forces
    it)."""
    global launches, reductions_per_tile
    from stainlib_tpu_torch.kernels import _build
    from stainlib_tpu_torch.kernels import macenko_fused as mf

    B, dev = x.shape[0], x.device
    n_pix = _n_pix(x, planar)
    plan = mf.cluster_plan(n_pix, "K9", g, B, mf.sm_count(dev))
    args = mf.staged_args(plan)
    scratch = mf.stage_scratch(plan, B, dev)
    (rows, rows_stride), (tgt, tgt_stride), (mct, mct_stride) = (
        _pointer_arg(stain_matrix_src, 6, B, dev),
        _pointer_arg(stain_matrix_tgt, 6, B, dev),
        _pointer_arg(max_c_target, 2, B, dev))
    out = torch.empty_like(x)
    pix_stride, ch_stride = (1, n_pix) if planar else (3, 1)
    _build.launch("fused_normalize_launch", dev, x.data_ptr(),
                  out.data_ptr(), rows.data_ptr(), rows_stride,
                  tgt.data_ptr(), tgt_stride, mct.data_ptr(), mct_stride,
                  _od_lasso_table(dev).data_ptr(), B, n_pix, pix_stride,
                  ch_stride, regularizer, q / 100.0, _ITERS, *args,
                  None if scratch is None else scratch.data_ptr())
    launches += 1
    reductions_per_tile = mf.chain_length("K9", args[3], it_conc=_ITERS)
    return out


def fused_normalize_planar(rgb_planar, stain_matrix_src, stain_matrix_tgt,
                           max_c_target, q: float = 99.0,
                           regularizer: float = 0.01):
    """Fused normalize over planar (B, 3, R, 128) uint8 tiles.

    ``stain_matrix_src``: (B, 2, 3) per-tile source stain matrices;
    ``stain_matrix_tgt``: (2, 3) or (B, 2, 3); ``max_c_target``: (2,) or
    (B, 2). On the card each tile is one cluster of
    ``macenko_fused.cluster_plan``'s G blocks, and a float32 tensor already
    on the tiles' device reaches the kernel by its own pointer. The JAX
    signature's ``interpret`` has no counterpart here.
    """
    _check(rgb_planar, planar=True)
    kw = dict(q=q, regularizer=regularizer)
    if rgb_planar.device.type == "cpu":
        return fused_normalize_planar_ref(rgb_planar, stain_matrix_src,
                                          stain_matrix_tgt, max_c_target,
                                          **kw)
    return _launch(rgb_planar, True, stain_matrix_src, stain_matrix_tgt,
                   max_c_target, **kw)


def fused_normalize(rgb, stain_matrix_src, stain_matrix_tgt, max_c_target,
                    **kw):
    """(B, H, W, 3) uint8 entry point; the kernel reads the interleaved
    bytes directly."""
    _check(rgb, planar=False)
    if rgb.device.type == "cpu":
        return fused_normalize_ref(rgb, stain_matrix_src, stain_matrix_tgt,
                                   max_c_target, **kw)
    return _launch(rgb, False, stain_matrix_src, stain_matrix_tgt,
                   max_c_target, **kw)
