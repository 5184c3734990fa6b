"""Fused Vahadane fit + transform and the fused dictionary kernel, one CUDA
thread-block cluster per tile.

Port of the JAX package's ``kernels/vahadane_fused.py``:

* ``vahadane_normalize_planar`` (``:342-404``, body
  ``_vahadane_full_kernel`` ``:111-215``): the whole per-tile pipeline of
  ``ExtractiveStainNormalizer('vahadane')``: the Macenko warm start, then
  ``num_iters`` block-coordinate-descent dictionary steps
  (``_bcd_iteration`` ``:218-278``) on the estimation sample, H-first
  ordering and row normalization, the apply lasso on every pixel, the
  99th-percentile rescale and ``255*exp(-C M_tgt)``. A tile with an
  empty mask keeps its start and reconstructs white as white.
* ``vahadane_stain_matrix_planar`` (``:286-332``, body ``_dict_kernel``
  ``:48-108``): the warm start and BCD only, ``[D(6), n_valid]`` per tile;
  the swap, normalization and NaN for an empty mask follow in torch.
* ``vahadane_normalize_planar_2k`` (``:407-421``): that dictionary kernel
  then the fixed-matrix apply kernel ``fused_stain.fused_normalize_planar``,
  the JAX package's reference for the single kernel.
* ``vahadane_augment_planar`` (``:432-465``): ``StainAugmentor('vahadane')``
  fit + pop, the dictionary kernel, the Ruifrok-Johnston prior where a
  tile's mask was empty, then the augment-apply kernel
  ``macenko_fused.augment_with_matrix_planar`` (K7).

Kernel source note (``csrc/vahadane_fused.cu``):

* Replaces the Pallas TPU kernels ``vahadane_normalize_planar`` /
  ``_vahadane_full_kernel`` and ``vahadane_stain_matrix_planar`` /
  ``_dict_kernel`` in the JAX package's ``kernels/vahadane_fused.py``.
* Bound: work per pixel and the chain of dependent reductions, as K1. At
  ``fit_stride=2, num_iters=8, n_bisect=10`` a 256^2 tile's passes visit
  16.5 tiles' worth of pixels (K1: 12.5); each BCD pass adds a lasso and
  nine products per tissue pixel.
* Design: both kernels run one thread-block cluster of
  :func:`~stainlib_tpu_torch.kernels.macenko_fused.cluster_plan`'s G
  blocks per tile, each owning a share of the estimation sample: the
  slice's bytes and mask bits, the pseudo-angles, then the two
  concentrations are staged in shared memory, so only the first pass and
  the apply read device memory and a bisection pass bins staged values
  into leaf histograms, up to eight rounds and the successor per
  reduction; reductions cross the cluster
  through distributed shared memory in rank order; a sample over 293K
  pixels is staged in device memory instead. A BCD iteration is one
  pass: lasso codes, the nine masked sums in one reduction, the row update
  on one thread, broadcast. K2's G follows the sample; the dictionary
  kernel's (K8) also the batch (16 for one image), and its blocks take
  the sample's 512-pixel chunks in turns, so a band of background idles
  none of them. Both share the phases in ``csrc/stain_common.cuh``.

On a CUDA tensor the wrappers launch the kernels; on a CPU tensor they run
the plain torch versions (``*_ref``), which follow the JAX kernel bodies
step for step and are the kernels' oracle. ``launches`` counts launches of
the fit+transform kernel, ``dict_launches`` of the dictionary kernel;
``reductions_per_tile`` holds the chain length of the last launch of
either.
"""

from __future__ import annotations

import torch

from stainlib_tpu_torch.kernels.fused_stain import (
    _check,
    _lasso2,
    _n_pix,
    _scale_and_reconstruct,
    _sum64,
    from_planar,
    fused_normalize_planar,
    to_planar,
)
from stainlib_tpu_torch.kernels.macenko_fused import (
    _macenko_rows,
    augment_with_matrix_planar,
    augment_with_matrix_planar_ref,
    _od_and_mask,
    _sample_args,
    _sample_index,
    _tables,
    _target_scalars,
    _y_threshold,
    chain_length,
    cluster_plan,
    sm_count,
    stage_scratch,
    staged_args,
)
from stainlib_tpu_torch.ops.dictlearn import _HE_INIT
from stainlib_tpu_torch.utils.profiling import kernel_entry

# Kernel launches since import (or since a caller reset them).
launches = 0  # vahadane_normalize kernel
dict_launches = 0  # vahadane_dict kernel
# Dependent cluster reductions per tile of the last K2 or K8 launch
# (``macenko_fused.chain_length``).
reductions_per_tile = 0

_Q_ANGLE = 99.0  # the warm start's angular percentile (:77-78, :149-150)


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def _bcd_iteration(D, od0, od1, od2, m, regularizer: float):
    """One BCD alternation (``_bcd_iteration``, ``:218-278``): exact lasso
    codes of every sample pixel, the nine masked sums, two row sweeps.
    ``D``: 6 (B,) tensors (row 0, then row 1); ``m``: (B, N) float mask."""
    a1, a2 = _lasso2(od0, od1, od2, D[:3], D[3:], regularizer)
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
    ``max(|row|, 1e-12)`` (``:176-189``); returns (h, e)."""
    swap = D[0] < D[3]
    h = [torch.where(swap, D[3 + i], D[i]) for i in range(3)]
    e = [torch.where(swap, D[i], D[3 + i]) for i in range(3)]
    hn = 1.0 / torch.clamp_min(
        torch.sqrt(h[0] * h[0] + h[1] * h[1] + h[2] * h[2]), 1e-12)
    en = 1.0 / torch.clamp_min(
        torch.sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]), 1e-12)
    return [x * hn for x in h], [x * en for x in e]


def _fit(rgb_planar, regularizer_fit, num_iters, luminosity_threshold,
         n_bisect, fit_stride):
    """Warm start + BCD on the estimation sample; returns the OD planes
    and mask of the whole tile, the sample index (None: whole tile), the
    dictionary D (6 (B,) tensors) and the tissue count n_valid."""
    od0, od1, od2, mask = _od_and_mask(rgb_planar, luminosity_threshold)
    idx = _sample_index(rgb_planar.shape[2], fit_stride, rgb_planar.device)

    def sub(t):
        return t if idx is None else t[:, idx]

    od0f, od1f, od2f, maskf = sub(od0), sub(od1), sub(od2), sub(mask)
    n_valid, h, e = _macenko_rows(od0f, od1f, od2f, maskf, _Q_ANGLE,
                                  n_bisect)
    D = h + e
    m = maskf.to(torch.float32)
    for _ in range(num_iters):
        D = _bcd_iteration(D, od0f, od1f, od2f, m, regularizer_fit)
    return (od0, od1, od2), idx, D, n_valid


def vahadane_normalize_planar_ref(
    rgb_planar,
    stain_matrix_tgt,
    max_c_target,
    regularizer_fit: float = 0.1,
    regularizer: float = 0.01,
    num_iters: int = 12,
    luminosity_threshold: float = 0.8,
    n_bisect: int = 14,
    q_conc: float = 99.0,
    fit_stride: int = 1,
):
    """Plain torch version of the fit+transform kernel over planar
    (B, 3, R, 128) uint8 tiles, step for step ``_vahadane_full_kernel``."""
    B, _, R, L = rgb_planar.shape
    scal = _target_scalars(stain_matrix_tgt, max_c_target, B,
                           rgb_planar.device)
    (od0, od1, od2), idx, D, _ = _fit(rgb_planar, regularizer_fit, num_iters,
                                      luminosity_threshold, n_bisect,
                                      fit_stride)
    h, e = _finalize_rows(D)
    c1, c2 = _lasso2(od0, od1, od2, h, e, regularizer)
    out = _scale_and_reconstruct(c1, c2, idx, q_conc, n_bisect, scal[:, :6],
                                 scal[:, 6:])
    return out.reshape(B, 3, R, L)


def vahadane_normalize_ref(rgb, stain_matrix_tgt, max_c_target, **kw):
    """Plain version over (B, H, W, 3) uint8 tiles."""
    _, H, W, _ = rgb.shape
    out = vahadane_normalize_planar_ref(to_planar(rgb), stain_matrix_tgt,
                                        max_c_target, **kw)
    return from_planar(out, H, W)


def _dict_plane_ref(rgb_planar, regularizer: float = 0.1,
                    num_iters: int = 12, luminosity_threshold: float = 0.8,
                    n_bisect: int = 14, fit_stride: int = 1):
    """Plain version of the dictionary kernel: (B, 8) float32 rows
    ``[D(6), n_valid, 0]`` (``_dict_kernel``'s output row)."""
    _, _, D, n_valid = _fit(rgb_planar, regularizer, num_iters,
                            luminosity_threshold, n_bisect, fit_stride)
    return torch.stack(D + [n_valid, torch.zeros_like(n_valid)], dim=1)


def _dict_post(plane):
    """(B, 8) dictionary rows -> (B, 2, 3) stain matrices: H first by the
    unnormalized red components, rows normalized, NaN where the mask was
    empty (the XLA post-pass at ``:324-332``)."""
    D = plane[:, :6].reshape(-1, 2, 3)
    swap = D[:, 0, 0] < D[:, 1, 0]
    row0 = torch.where(swap[:, None], D[:, 1], D[:, 0])
    row1 = torch.where(swap[:, None], D[:, 0], D[:, 1])
    D = torch.stack([row0, row1], dim=1)
    D = D / torch.clamp_min(torch.linalg.vector_norm(D, dim=-1, keepdim=True),
                            1e-12)
    return torch.where((plane[:, 6] > 0)[:, None, None], D, torch.nan)


def vahadane_stain_matrix_planar_ref(rgb_planar, **kw):
    """Plain version of :func:`vahadane_stain_matrix_planar`."""
    return _dict_post(_dict_plane_ref(rgb_planar, **kw))


# ---------------------------------------------------------------------------
# Wrappers: validate, then the CUDA kernel (CUDA tensor) or the plain
# version (CPU tensor).
# ---------------------------------------------------------------------------


@kernel_entry("K2")
def _launch(x, planar: bool, stain_matrix_tgt, max_c_target,
            regularizer_fit: float = 0.1, regularizer: float = 0.01,
            num_iters: int = 12, luminosity_threshold: float = 0.8,
            n_bisect: int = 14, q_conc: float = 99.0, fit_stride: int = 1,
            g: int | None = None):
    """K2 on CUDA tiles at :func:`cluster_plan`'s G (``g`` forces it)."""
    global launches, reductions_per_tile
    from stainlib_tpu_torch.kernels import _build

    B, dev = x.shape[0], x.device
    n_pix = _n_pix(x, planar)
    nblk, blk, stp = _sample_args(n_pix, fit_stride)
    plan = cluster_plan(nblk * blk, "K2", g)
    args = staged_args(plan)
    it_angle = max(n_bisect - 4, 8)
    scratch = stage_scratch(plan, B, dev)
    scal = _target_scalars(stain_matrix_tgt, max_c_target, B, dev)
    out = torch.empty_like(x)
    pix_stride, ch_stride = (1, n_pix) if planar else (3, 1)
    _build.launch("vahadane_normalize_launch", dev, x.data_ptr(),
                  out.data_ptr(), scal.data_ptr(), _tables(dev).data_ptr(),
                  B, n_pix, pix_stride, ch_stride, nblk, blk, stp,
                  _y_threshold(luminosity_threshold), regularizer_fit,
                  regularizer, (100.0 - _Q_ANGLE) / 100.0, _Q_ANGLE / 100.0,
                  q_conc / 100.0, num_iters, it_angle, n_bisect, *args,
                  None if scratch is None else scratch.data_ptr())
    launches += 1
    reductions_per_tile = chain_length("K2", args[3], it_angle, n_bisect,
                                       num_iters)
    return out


def vahadane_normalize_planar(
    rgb_planar,
    stain_matrix_tgt,
    max_c_target,
    regularizer_fit: float = 0.1,
    regularizer: float = 0.01,
    num_iters: int = 12,
    luminosity_threshold: float = 0.8,
    n_bisect: int = 14,
    q_conc: float = 99.0,
    fit_stride: int = 1,
):
    """Full Vahadane fit+transform over planar (B, 3, R, 128) uint8 tiles.

    ``stain_matrix_tgt``: (2, 3) or (B, 2, 3); ``max_c_target``: (2,) or
    (B, 2). ``regularizer_fit`` is the dictionary learner's L1 weight,
    ``regularizer`` the apply lasso's. ``fit_stride`` restricts the warm
    start, the BCD and the concentration percentile to the JAX kernel's
    stratified row sample; the apply covers every pixel. On the card each
    tile is one cluster of ``cluster_plan``'s G blocks. The JAX
    signature's TPU-only knobs (``interpret``, ``tiles_per_step``,
    ``n_cands``) have no counterpart here.
    """
    _check(rgb_planar, planar=True)
    kw = dict(regularizer_fit=regularizer_fit, regularizer=regularizer,
              num_iters=num_iters, luminosity_threshold=luminosity_threshold,
              n_bisect=n_bisect, q_conc=q_conc, fit_stride=fit_stride)
    if rgb_planar.device.type == "cpu":
        return vahadane_normalize_planar_ref(rgb_planar, stain_matrix_tgt,
                                             max_c_target, **kw)
    return _launch(rgb_planar, True, stain_matrix_tgt, max_c_target, **kw)


def vahadane_normalize(rgb, stain_matrix_tgt, max_c_target, **kw):
    """(B, H, W, 3) uint8 entry point; the kernel reads the interleaved
    bytes directly (the estimation sample is defined on the flat pixel
    index, the same in both layouts)."""
    _check(rgb, planar=False)
    if rgb.device.type == "cpu":
        return vahadane_normalize_ref(rgb, stain_matrix_tgt, max_c_target,
                                      **kw)
    return _launch(rgb, False, stain_matrix_tgt, max_c_target, **kw)


@kernel_entry("K8")
def _dict_launch(rgb_planar, regularizer: float = 0.1, num_iters: int = 12,
                 luminosity_threshold: float = 0.8, n_bisect: int = 14,
                 fit_stride: int = 1, g: int | None = None):
    """K8 on CUDA tiles at :func:`cluster_plan`'s G (``g`` forces it):
    the (B, 8) rows ``[D(6), n_valid, 0]``."""
    global dict_launches, reductions_per_tile
    from stainlib_tpu_torch.kernels import _build

    B, dev = rgb_planar.shape[0], rgb_planar.device
    n_pix = _n_pix(rgb_planar, True)
    nblk, blk, stp = _sample_args(n_pix, fit_stride)
    plan = cluster_plan(nblk * blk, "K8", g, B, sm_count(dev))
    args = staged_args(plan)
    it_angle = max(n_bisect - 4, 8)
    scratch = stage_scratch(plan, B, dev)
    plane = torch.empty((B, 8), dtype=torch.float32, device=dev)
    _build.launch("vahadane_dict_launch", dev, rgb_planar.data_ptr(),
                  plane.data_ptr(), _tables(dev).data_ptr(), B, n_pix, 1,
                  n_pix, nblk, blk, stp, _y_threshold(luminosity_threshold),
                  regularizer, (100.0 - _Q_ANGLE) / 100.0, _Q_ANGLE / 100.0,
                  num_iters, it_angle, *args,
                  None if scratch is None else scratch.data_ptr())
    dict_launches += 1
    reductions_per_tile = chain_length("K8", args[3], it_angle,
                                       num_iters=num_iters)
    return plane


def vahadane_stain_matrix_planar(rgb_planar, regularizer: float = 0.1,
                                 num_iters: int = 12,
                                 luminosity_threshold: float = 0.8,
                                 n_bisect: int = 14, fit_stride: int = 1):
    """Per-tile (B, 2, 3) Vahadane stain matrices from planar uint8 tiles:
    the dictionary kernel (on the card one cluster of ``cluster_plan``'s G
    blocks per tile), then H-first ordering and row normalization in
    torch; an empty mask gives NaN, as the functional path does."""
    _check(rgb_planar, planar=True)
    kw = dict(regularizer=regularizer, num_iters=num_iters,
              luminosity_threshold=luminosity_threshold, n_bisect=n_bisect,
              fit_stride=fit_stride)
    if rgb_planar.device.type == "cpu":
        return vahadane_stain_matrix_planar_ref(rgb_planar, **kw)
    return _dict_post(_dict_launch(rgb_planar, **kw))


def vahadane_normalize_planar_2k(rgb_planar, stain_matrix_tgt, max_c_target,
                                 regularizer_fit: float = 0.1,
                                 regularizer: float = 0.01,
                                 num_iters: int = 12):
    """The two-kernel pipeline (``:407-421``): per-tile dictionary
    matrices, then the fixed-matrix apply kernel. The matrix-producing
    reference for :func:`vahadane_normalize_planar`."""
    M_src = vahadane_stain_matrix_planar(
        rgb_planar, regularizer=regularizer_fit, num_iters=num_iters)
    return fused_normalize_planar(rgb_planar, M_src, stain_matrix_tgt,
                                  max_c_target, regularizer=regularizer)


def _prior_where_nan(M):
    """Empty-mask tiles' NaN rows -> the Ruifrok-Johnston prior (their
    pixels are background and pass the tissue gate unperturbed)."""
    prior = torch.as_tensor(_HE_INIT, device=M.device).expand(M.shape)
    return torch.where(torch.isnan(M), prior, M)


def vahadane_augment_planar(rgb_planar, alpha, beta,
                            luminosity_threshold: float = 0.8,
                            regularizer_fit: float = 0.1,
                            regularizer: float = 0.01, num_iters: int = 12,
                            augment_background: bool = False):
    """Fused Vahadane ``StainAugmentor`` fit + pop over planar
    (B, 3, R, 128) uint8 tiles (``vahadane_fused.py:432-458``): the
    dictionary kernel (K8) for each tile's stain matrix, the prior where
    it is NaN, then the augment-apply kernel (K7). ``alpha``/``beta``:
    (B, 2) per-image per-stain draws. The JAX signature's ``interpret``
    has no counterpart here."""
    M = _prior_where_nan(vahadane_stain_matrix_planar(
        rgb_planar, regularizer=regularizer_fit, num_iters=num_iters,
        luminosity_threshold=luminosity_threshold))
    return augment_with_matrix_planar(
        rgb_planar, M, alpha, beta,
        luminosity_threshold=luminosity_threshold, regularizer=regularizer,
        augment_background=augment_background)


def vahadane_augment_planar_ref(rgb_planar, alpha, beta,
                                luminosity_threshold: float = 0.8,
                                regularizer_fit: float = 0.1,
                                regularizer: float = 0.01,
                                num_iters: int = 12,
                                augment_background: bool = False):
    """Plain version of :func:`vahadane_augment_planar`: the plain K8, then
    the plain K7, on any device."""
    M = _prior_where_nan(vahadane_stain_matrix_planar_ref(
        rgb_planar, regularizer=regularizer_fit, num_iters=num_iters,
        luminosity_threshold=luminosity_threshold))
    return augment_with_matrix_planar_ref(
        rgb_planar, M, alpha, beta,
        luminosity_threshold=luminosity_threshold, regularizer=regularizer,
        augment_background=augment_background)


def vahadane_augment(rgb, alpha, beta, **kw):
    """(B, H, W, 3) uint8 entry point (lane-aligned tiles)."""
    _check(rgb, planar=False)
    _, H, W, _ = rgb.shape
    out = vahadane_augment_planar(to_planar(rgb).contiguous(), alpha, beta,
                                  **kw)
    return from_planar(out, H, W)
