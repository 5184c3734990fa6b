"""Fused Macenko kernels: fit + transform (K1), fit alone (K4), the
eigenplane (K10), the fixed-matrix apply (K3), and the stain-augmentation
kernels: the fused augment (K6) and the augment apply (K7).

Port of the JAX package's ``kernels/macenko_fused.py``:

* K1 ``macenko_normalize_planar`` (``:541-616``, body ``_apply_kernel``
  ``:413-490``): the whole per-tile pipeline of
  ``ExtractiveStainNormalizer('macenko')`` (``stainlib/normalization/
  normalizer.py:39-50`` + ``macenko_stain_extractor.py:7-44``);
* K4 ``macenko_fit_planar`` (``:688-736``, body ``_fit_kernel``): K1's
  phases 1-4, the stain rows and maxC per tile, for the tiled route;
* K10 ``eigenplane`` (``:498-532``, body ``_stats_kernel``): the masked OD
  moments per tile and the glue XLA fuses after them, ``np.cov``'s
  covariance and the top-2 eigenplane, in one kernel;
* K3 ``normalize_with_matrix_planar`` (``:936-991``, body
  ``_augment_kernel`` with a fixed matrix): lasso against given source
  rows, rescale, reconstruction through the target, per pixel;
* K6 ``macenko_augment_planar`` (``:822-871``, body ``_augment_kernel``
  ``:754-813`` with ``estimate=True``): ``StainAugmentor`` fit + pop per
  tile (``stainlib/augmentation/augmenter.py:403-448``): the in-kernel
  Macenko estimate, the exact lasso, ``C*alpha+beta`` on tissue pixels
  (every pixel with ``augment_background``), reconstruction through the
  tile's own rows;
* K7 ``augment_with_matrix_planar`` (``:886-929``, the same body with
  ``estimate=False``): the same per-pixel part against given rows, per
  pixel: ``StainAugmentor.pop`` with the fit hoisted out.

Kernel source note (``csrc/macenko_fused.cu``):

* Replaces the six Pallas TPU kernels above.
* Bound: K1, K4 and K6 by work per pixel, not bytes (2 x 196 KB per 256^2
  tile), and by their chain of dependent reductions (moments, angle
  min/max, the angle and concentration bisection rounds, the successor
  recoveries) with scalar 3x3 work between them. K10 is one pass, bound
  by its instructions per pixel (nine double sums of float terms under the
  bit rules); K3 and K7 have no reduction: a lasso and three ``expf`` per
  pixel, bytes in and out.
* Design: K1, K4 and K6 run one thread-block cluster of
  :func:`cluster_plan`'s G blocks of 512 threads per tile: each block
  stages its share of the sample's bytes, pseudo-angles, then
  concentrations, in shared memory, so only the first pass (and the apply
  of K1 and K6) reads device memory and a bisection pass bins staged
  values into leaf histograms in shared memory, up to eight rounds and the
  successor per reduction (:func:`hist_levels`, :func:`chain_length`:
  K1's chain is 6 reductions at ``fit_stride=2, n_bisect=10``); the
  reductions cross the cluster through distributed shared memory in rank
  order, so every G gives the same bytes. A sample over 293K pixels is staged in device memory
  instead. K4 takes G = 16 (the tiled route's batch is one subsample);
  K1's and K6's G follow the batch (16 for one image, two blocks per tile
  staged in device memory for 256 tiles), their blocks take the sample's
  512-pixel chunks in turns, and their apply pass, split over the
  cluster, moves 8 pixels per thread and step through 64-bit accesses
  with the lazy lasso and a one-instruction uint8 conversion (K6 through
  K7's per-pixel body, with alpha and beta by pointer and stride). K10
  runs one cluster of :func:`eigenplane_plan`'s G blocks of 512 threads per
  tile: 16 pixels per thread and step through 128-bit loads, the moments
  folded over the warps and the cluster's ranks in a fixed order (no float
  atomics, so the output is bit-reproducible and the same at every G), then
  one thread per tile runs :func:`_eigenplane_from_moments` in float32 op
  for op, so the entry is one launch. OD and the luminance terms come from
  256-entry tables built on the CPU, so the kernels take no ``log`` per
  pass and see the same OD bits as the plain versions. K7 and K3 run a 1-D
  persistent grid sized from the card over (image, chunk) work items: the
  tables go into shared memory once per block (K7's OD and luminance term
  side by side, one 8-byte gather per channel); a thread takes 16 planar
  (K7) or 8 pixels per step through 128-bit or 64-bit accesses, with a
  scalar head and tail where an interleaved image is off the vector grid;
  the lasso's one-stain quotients are taken only where they are read; and
  the per-image values (K7's rows, alpha and beta; K3's source
  and target rows and maxC) arrive by pointer and stride
  (:func:`_augment_args`, :func:`_matrix_args`), so the wrapper builds no
  table; K3 takes each image's rescale in the kernel.

On a CUDA tensor the wrappers launch the kernels; on a CPU tensor they run
the plain torch versions (``*_ref``), which mirror the TPU kernels step for
step and are the kernels' oracles. ``launches``, ``fit_launches``,
``eigenplane_launches``, ``matrix_launches``, ``aug_launches`` and
``augment_launches`` count the launches of K1, K4, K10, K3, K6 and K7;
``reductions_per_tile`` holds the chain length of the last K1, K4 or K6
launch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from stainlib_tpu_torch.kernels.fused_stain import (
    LANES,
    _check,
    _conc_maxc,
    _lasso2,
    _multi_masked_percentile,
    _n_pix,
    _per_tile,
    _pointer_arg,
    _reconstruct_u8,
    _scale_and_reconstruct,
    _sum64,
    from_planar,
    to_planar,
)
from stainlib_tpu_torch.ops.fdiv import fdiv
from stainlib_tpu_torch.ops.linalg3 import eigh3x3
from stainlib_tpu_torch.utils.profiling import kernel_entry

# Kernel launches since import (or since a caller reset it).
launches = 0
matrix_launches = 0
fit_launches = 0
eigenplane_launches = 0
aug_launches = 0  # K6
augment_launches = 0  # K7
# Dependent cluster reductions per tile of the last K1, K4 or K6 launch
# (:func:`chain_length`).
reductions_per_tile = 0

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
    of ``_od_and_mask`` (``macenko_fused.py:60-85``). Built on the CPU and
    copied, once per device, so the kernel and the plain version read the
    same table on every device (torch's CUDA ``log`` and its division by a
    scalar round differently from the CPU's)."""
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
    """Linear-luminance threshold equivalent to ``L/100 < t`` (L* is
    monotone in Y), in the kernel's f32 arithmetic. Cached: the wrappers
    call it on every launch."""
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


# Thread-block clusters of the staged kernels (K1, K2, K4, K6, K8, K9): a
# tile's sample is split over G blocks of 512 threads, each staging 12 bytes
# per sample pixel (two float32 bisection operands, the pixel's bytes and
# mask bit; K9 stages its two concentrations only).
CLUSTER_SIZES = (1, 2, 4, 8, 16)
STAGE_BYTES = 12
_THREADS = 512
_SMEM_SM = 228 * 1024  # an H100 SM's shared memory
_SMEM_BLOCK = 227 * 1024  # one block's opt-in maximum
# The kernels' static shared memory (9.6 KB: tables, reduction buffers, the
# cluster's slots, a 4-level bisection histogram) and the 1 KB the runtime
# keeps per block, rounded up.
_SMEM_STATIC = 12 * 1024
_MIN_SLICE = 16384  # sample pixels per block below which a big batch's
#                     tiles are not split (cluster_plan)


class ClusterPlan(NamedTuple):
    g: int  # blocks per tile, the cluster size
    slice: int  # sample pixels staged per block; g * slice >= the sample
    smem: int  # dynamic shared memory per block, bytes; 0: the stages lie
    #            in a device-memory scratch buffer (:func:`stage_scratch`)


def cluster_plan(n_sample: int, kernel: str, g: int | None = None,
                 batch: int = 1, sms: int = 132) -> ClusterPlan:
    """The cluster size G and the shared memory per block of a staged
    kernel for tiles whose estimation sample holds ``n_sample`` pixels:
    ``"K1"`` (Macenko fit + transform), ``"K8"`` (the Vahadane dictionary),
    ``"K6"`` (the fused Macenko augment), ``"K9"`` (the fixed-matrix
    normalize; K6's and K9's sample is the whole tile), ``"K4"`` (the
    Macenko fit) or ``"K2"`` (Vahadane fit + transform).

    K4 takes G = 16: the tiled route fits one subsample per field, so the
    cluster spreads it over as many SMs as a cluster can hold. K2 takes the
    smallest G whose slice leaves room for two blocks per SM, else 16. A
    slice larger than one block's shared memory (a sample over 293K pixels
    at G = 16) is staged in device memory instead (``smem`` 0).

    K1, K6, K8 and K9 run on one image (the drop-in ``transform``,
    ``stain_augment`` on one image, an augmentor's fit) and on hundreds of
    tiles, so their plan also weighs ``batch`` against the card's ``sms``
    streaming multiprocessors (an H100's 132), by the rule
    ``scripts/torch_cluster_sweep.py`` measured on an H100:

    * the largest G whose ``batch * G`` blocks find an SM each, staged in
      shared memory where a block holds the slice (16 for one image, 8 for
      16 tiles, 2 for 64 tiles of 256x256 at ``fit_stride=2``);
    * where no such G keeps the slice in shared memory, that G or 2,
      whichever is larger, staged in device memory: two fat blocks per
      tile, two to an SM, beat more and thinner ones by their shorter
      chains of reductions (128 and 256 tiles of 256x256 or 512x512); a
      sample under 32,768 pixels is not split at all (256 tiles of
      128x128: G = 1);
    * a cluster of 8 or 16 blocks whose slices need a whole SM's shared
      memory each keeps them there only while it has the card to itself
      (``batch * G`` up to half the SMs); else it is staged in device
      memory, which leaves two blocks per SM (16 tiles of 512x512: clusters
      of 8 or 16 whole SMs do not all find room at once);
    * K6 and K9 estimate over the whole tile. K6 takes 16 blocks per tile
      wherever the rule stages in device memory and ``batch * 16`` blocks
      fit two to an SM (9 to 16 tiles of 512x512: 17% faster than 8). K9,
      whose estimate is one lasso pass and no moments or angles, gains
      from more blocks: wherever the rule stages in device memory it takes
      slices of at most 16,384 pixels (4 blocks per 256x256 tile, 11%
      faster than 2 at 256 tiles; 16 per 512x512 tile).

    Their blocks take the sample in chunks of 512 pixels dealt out in
    turns, so a slice is a whole number of chunks. ``g`` forces G, staged
    in shared memory wherever a block holds the slice (tests and
    measurements).
    """
    if kernel not in ("K1", "K2", "K4", "K6", "K8", "K9"):
        raise ValueError(f"no cluster plan for kernel {kernel!r}")
    batched = kernel in ("K1", "K6", "K8", "K9")

    chunks = -(-n_sample // _THREADS)

    def slice_of(size):
        return _THREADS * -(-chunks // size) if batched else -(
            -n_sample // size)

    def stage(size):
        return STAGE_BYTES * slice_of(size)

    one = _SMEM_BLOCK - _SMEM_STATIC
    two = _SMEM_SM // 2 - _SMEM_STATIC
    device = False
    if g is None and batched:
        own = [s for s in CLUSTER_SIZES if batch * s <= sms and s <= chunks]
        few = [s for s in own if stage(s) <= one]
        if few:
            g = few[-1]
            device = stage(g) > two and g > 4 and 2 * batch * g > sms
        else:
            g = max([2 if n_sample >= 2 * _MIN_SLICE else 1] + own)
            device = True
        if device and kernel == "K9":
            g = next((s for s in CLUSTER_SIZES if slice_of(s) <= _MIN_SLICE),
                     CLUSTER_SIZES[-1])
        elif (device and kernel == "K6" and 16 * batch <= 2 * sms
              and chunks >= 16):
            g = 16  # two blocks to an SM
    elif g is None:
        fits = [s for s in CLUSTER_SIZES if stage(s) <= two]
        g = fits[0] if fits and kernel != "K4" else CLUSTER_SIZES[-1]
    if g not in CLUSTER_SIZES:
        raise ValueError(f"cluster size {g} is not one of {CLUSTER_SIZES}")
    return ClusterPlan(g, slice_of(g),
                       0 if device or stage(g) > one else stage(g))


# K10 stages nothing, so its cluster size follows the batch alone. A block
# of 512 threads reads 16 pixels per thread and step, so a part under 4096
# pixels leaves threads idle.
_EIGEN_MIN_PART = 4096


def eigenplane_plan(batch: int, n_pix: int, sms: int = 132,
                    g: int | None = None) -> int:
    """K10's cluster size G for ``batch`` tiles of ``n_pix`` pixels on a card
    with ``sms`` streaming multiprocessors (an H100's 132 by default): the
    largest G whose ``batch * G`` blocks find an SM each and whose parts
    keep 4096 pixels, so one 256x256 tile spreads over 16 SMs, 16 tiles
    over 8 each and 256 tiles run one block each. Within 1.04x of the best
    G at every batch of ``scripts/torch_cluster_sweep.py --kernels K10``
    (1 to 256 tiles of 256x256, 1 to 16 of 512x512, on an H100); two
    blocks to an SM (the card's 264 block slots) ran up to 1.30x behind.
    ``g`` forces G (tests and measurements); every G gives the same
    bits."""
    if g is None:
        fits = [s for s in CLUSTER_SIZES
                if batch * s <= sms and n_pix >= s * _EIGEN_MIN_PART]
        g = fits[-1] if fits else 1
    if g not in CLUSTER_SIZES:
        raise ValueError(f"cluster size {g} is not one of {CLUSTER_SIZES}")
    return g


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stage_scratch(plan: ClusterPlan, batch: int, device):
    """The device-memory stages of ``batch`` tiles under a plan whose
    slices fit no block's shared memory (``plan.smem == 0``), else None."""
    if plan.smem:
        return None
    return torch.empty(batch * plan.g * STAGE_BYTES // 4 * plan.slice,
                       dtype=torch.float32, device=device)


# The staged kernels' percentile searches (``staged_percentile_pair`` in
# ``csrc/stain_common.cuh``) take up to ``levels`` bisection rounds and the
# successor per cluster reduction, from a leaf histogram of 2^levels leaves
# per search in shared memory: 4 * (10 * 2^levels + 10) bytes with its two
# parities and thresholds. The kernels' static shared memory holds 4 levels;
# more take dynamic shared memory after the stage, as far as the room the
# plan leaves allows.
_MAX_LEVELS = 8
_STATIC_LEVELS = 4


def hist_bytes(levels: int) -> int:
    """Dynamic shared memory of the bisection histograms at ``levels``
    (0: the kernels' static shared memory holds them)."""
    return 0 if levels <= _STATIC_LEVELS else 4 * (10 * 2 ** levels + 10)


def hist_levels(plan: ClusterPlan) -> int:
    """The most bisection rounds per reduction under ``plan``: the largest
    level count up to 8 whose histograms fit beside the plan's stage, in
    half an SM's shared memory where the stage leaves two blocks to an SM
    (or lies in device memory), else in one block's."""
    room = (_SMEM_SM // 2 if plan.smem <= _SMEM_SM // 2 - _SMEM_STATIC
            else _SMEM_BLOCK) - _SMEM_STATIC - plan.smem
    return next((lv for lv in range(_MAX_LEVELS, _STATIC_LEVELS, -1)
                 if hist_bytes(lv) <= room), _STATIC_LEVELS)


def staged_args(plan: ClusterPlan):
    """A staged kernel's launch arguments from its plan: G, the slice, the
    dynamic shared memory (stage and histograms) and the levels."""
    levels = hist_levels(plan)
    return plan.g, plan.slice, plan.smem + hist_bytes(levels), levels


def bisection_passes(iters: int, levels: int) -> int:
    """Cluster reductions of one pair of percentile searches of ``iters``
    rounds at ``levels`` rounds per reduction, the successor included."""
    return max(1, -(-iters // levels))


def chain_length(kernel: str, levels: int, it_angle: int = 0,
                 it_conc: int = 0, num_iters: int = 0) -> int:
    """The dependent cluster reductions per tile of a staged kernel:
    the moments and the angles' extremes, the angle searches (K1, K2, K4,
    K6, K8), ``num_iters`` BCD steps (K2, K8), the concentrations' maxima
    and their searches (K1, K2, K4, K9)."""
    n = 0
    if kernel != "K9":
        n += 2 + bisection_passes(it_angle, levels)
    if kernel in ("K2", "K8"):
        n += num_iters
    if kernel in ("K1", "K2", "K4", "K9"):
        n += 1 + bisection_passes(it_conc, levels)
    return n


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


def _masked_moments(od0, od1, od2, mask):
    """The ten masked OD moments (``_od_moments``, ``macenko_fused.py:93-108``)
    as a list of (B,): the tissue count, the three OD sums, the upper
    triangle of the second moments; sums in float64, rounded once."""
    m = mask.to(torch.float32)
    return [m.sum(-1)] + [_sum64(m * o) for o in (od0, od1, od2)] + [
        _sum64(m * a * b)
        for a, b in ((od0, od0), (od0, od1), (od0, od2),
                     (od1, od1), (od1, od2), (od2, od2))]


def _macenko_rows(od0, od1, od2, mask, angular_percentile: float,
                  n_bisect: int):
    """The Macenko estimate from a tile's estimation sample: masked
    moments -> eigenplane -> the two masked angular percentiles -> H-first
    row-normalized stain rows (``_apply_kernel``'s phases 1-3, the
    Vahadane kernels' warm start). Returns (n_valid, h, e)."""
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


@kernel_entry("K1")
def _launch(x, planar: bool, stain_matrix_tgt, max_c_target,
            luminosity_threshold: float = 0.8,
            angular_percentile: float = 99.0, q_conc: float = 99.0,
            regularizer: float = 0.01, n_bisect: int = 14,
            fit_stride: int = 1, g: int | None = None):
    """K1 on CUDA tiles at :func:`cluster_plan`'s G (``g`` forces it)."""
    global launches, reductions_per_tile
    from stainlib_tpu_torch.kernels import _build

    B, dev = x.shape[0], x.device
    n_pix = _n_pix(x, planar)
    nblk, blk, stp = _sample_args(n_pix, fit_stride)
    plan = cluster_plan(nblk * blk, "K1", g, B, sm_count(dev))
    args = staged_args(plan)
    it_angle = max(n_bisect - 4, 8)
    scratch = stage_scratch(plan, B, dev)
    scal = _target_scalars(stain_matrix_tgt, max_c_target, B, dev)
    out = torch.empty_like(x)
    pix_stride, ch_stride = (1, n_pix) if planar else (3, 1)
    _build.launch("macenko_normalize_launch", dev, x.data_ptr(),
                  out.data_ptr(), scal.data_ptr(), _tables(dev).data_ptr(),
                  B, n_pix, pix_stride, ch_stride, nblk, blk, stp,
                  _y_threshold(luminosity_threshold), regularizer,
                  (100.0 - angular_percentile) / 100.0,
                  angular_percentile / 100.0, q_conc / 100.0, it_angle,
                  n_bisect, *args,
                  None if scratch is None else scratch.data_ptr())
    launches += 1
    reductions_per_tile = chain_length("K1", args[3], it_angle, n_bisect)
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
    JAX kernel's stratified row sample; the apply covers every pixel. On
    the card each tile is one cluster of ``cluster_plan``'s G blocks. The
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


# ---------------------------------------------------------------------------
# K4: the Macenko fit alone (stain rows and maxC per tile).
# ---------------------------------------------------------------------------


def macenko_fit_planar_ref(rgb_planar, luminosity_threshold: float = 0.8,
                           angular_percentile: float = 99.0,
                           q_conc: float = 99.0, regularizer: float = 0.01,
                           n_bisect: int = 14):
    """Plain torch version of the fit kernel over planar (B, 3, R, 128)
    uint8 tiles, step for step ``_fit_kernel`` (``:628-679``): K1's phases
    1-4 on the whole tile. Returns (B, 2, 3) stain rows, (B, 2) maxC."""
    od0, od1, od2, mask = _od_and_mask(rgb_planar, luminosity_threshold)
    _, h, e = _macenko_rows(od0, od1, od2, mask, angular_percentile,
                            n_bisect)
    c1, c2 = _lasso2(od0, od1, od2, h, e, regularizer)
    maxc = _conc_maxc(c1, c2, None, q_conc, n_bisect)
    return (torch.stack([torch.stack(h, -1), torch.stack(e, -1)], dim=1),
            torch.stack(maxc, -1))


@kernel_entry("K4")
def _fit_launch(rgb_planar, luminosity_threshold: float = 0.8,
                angular_percentile: float = 99.0, q_conc: float = 99.0,
                regularizer: float = 0.01, n_bisect: int = 14,
                g: int | None = None):
    """K4 on CUDA tiles at :func:`cluster_plan`'s G (``g`` forces it)."""
    global fit_launches, reductions_per_tile
    from stainlib_tpu_torch.kernels import _build

    B, dev = rgb_planar.shape[0], rgb_planar.device
    n_pix = _n_pix(rgb_planar, True)
    plan = cluster_plan(n_pix, "K4", g)
    args = staged_args(plan)
    it_angle = max(n_bisect - 4, 8)
    scratch = stage_scratch(plan, B, dev)
    plane = torch.empty((B, 8), dtype=torch.float32, device=dev)
    _build.launch("macenko_fit_launch", dev, rgb_planar.data_ptr(),
                  plane.data_ptr(), _tables(dev).data_ptr(), B, n_pix, 1,
                  n_pix, _y_threshold(luminosity_threshold), regularizer,
                  (100.0 - angular_percentile) / 100.0,
                  angular_percentile / 100.0, q_conc / 100.0, it_angle,
                  n_bisect, *args,
                  None if scratch is None else scratch.data_ptr())
    fit_launches += 1
    reductions_per_tile = chain_length("K4", args[3], it_angle, n_bisect)
    return plane[:, :6].reshape(B, 2, 3), plane[:, 6:8]


def macenko_fit_planar(rgb_planar, luminosity_threshold: float = 0.8,
                       angular_percentile: float = 99.0, q_conc: float = 99.0,
                       regularizer: float = 0.01, n_bisect: int = 14):
    """Macenko estimation over planar (B, 3, R, 128) uint8 tiles with no
    apply (``macenko_fused.py:688-736``): ``(stain_matrix (B, 2, 3),
    max_c (B, 2))``, the per-image half of ``normalizer.py:45-48``. On the
    card each tile is one cluster of :func:`cluster_plan`'s G blocks. The
    JAX signature's TPU-only knobs
    (``interpret``, ``tiles_per_step``, ``n_cands``) have no counterpart
    here."""
    _check(rgb_planar, planar=True)
    kw = dict(luminosity_threshold=luminosity_threshold,
              angular_percentile=angular_percentile, q_conc=q_conc,
              regularizer=regularizer, n_bisect=n_bisect)
    if rgb_planar.device.type == "cpu":
        return macenko_fit_planar_ref(rgb_planar, **kw)
    return _fit_launch(rgb_planar, **kw)


# ---------------------------------------------------------------------------
# K10: masked OD moments -> top-2 eigenplane.
# ---------------------------------------------------------------------------


def _eigenplane_from_moments(st):
    """(B, 10) masked OD moments -> (B, 3, 2) eigenplane: ``np.cov``'s N-1
    covariance, ``ops.linalg3.eigh3x3``, columns (2, 1), each column's red
    component made non-negative (the glue at ``macenko_fused.py:518-532``)."""
    n = torch.clamp_min(st[:, 0], 1.0)
    mean = st[:, 1:4] / n[:, None]
    sum_sq = st[:, [[4, 5, 6], [5, 7, 8], [6, 8, 9]]]
    cov = sum_sq - n[:, None, None] * mean[:, :, None] * mean[:, None, :]
    cov = cov / torch.clamp_min(n - 1.0, 1.0)[:, None, None]
    _, V = eigh3x3(cov)
    V2 = V[..., :, [2, 1]]
    return V2 * torch.where(V2[..., 0:1, :] < 0.0, -1.0, 1.0)


def eigenplane_ref(rgb_planar, luminosity_threshold: float = 0.8):
    """Plain torch version of :func:`eigenplane`: the moments of
    ``_stats_kernel`` (``:237-248``) in float64 sums, then the same glue."""
    od0, od1, od2, mask = _od_and_mask(rgb_planar, luminosity_threshold)
    return _eigenplane_from_moments(
        torch.stack(_masked_moments(od0, od1, od2, mask), dim=1))


@kernel_entry("K10")
def _eigen_launch(rgb_planar, luminosity_threshold: float = 0.8,
                  g: int | None = None):
    """K10 on CUDA tiles at :func:`eigenplane_plan`'s G (``g`` forces it)."""
    global eigenplane_launches
    from stainlib_tpu_torch.kernels import _build

    B, dev = rgb_planar.shape[0], rgb_planar.device
    n_pix = _n_pix(rgb_planar, True)
    G = eigenplane_plan(B, n_pix, sm_count(dev), g)
    out = torch.empty((B, 3, 2), dtype=torch.float32, device=dev)
    _build.launch("eigenplane_launch", dev, rgb_planar.data_ptr(),
                  out.data_ptr(), _tables(dev).data_ptr(), B, n_pix,
                  _y_threshold(luminosity_threshold), G)
    eigenplane_launches += 1
    return out


def eigenplane(rgb_planar, luminosity_threshold: float = 0.8):
    """Top-2 eigenvector plane of the masked OD covariance per planar
    (B, 3, R, 128) uint8 tile (``macenko_fused.py:498-532``). Returns
    (B, 3, 2) float32. On the card one kernel launch computes the moments
    and the eigen-solve; each tile is one cluster of
    :func:`eigenplane_plan`'s G blocks."""
    _check(rgb_planar, planar=True)
    if rgb_planar.device.type == "cpu":
        return eigenplane_ref(rgb_planar, luminosity_threshold)
    return _eigen_launch(rgb_planar, luminosity_threshold)


# ---------------------------------------------------------------------------
# K3: normalize against fixed source matrices (no estimation).
# ---------------------------------------------------------------------------


def _matrix_scalars(stain_matrix_src, max_c_src, stain_matrix_tgt,
                    max_c_tgt, regularizer, batch, device):
    """The plain version's (B, 16) per-image table: source rows, the rescale
    ``max_c_tgt / max(max_c_src, 1e-8)`` (``:964``), target rows, the
    regularizer, pad."""
    mcs = _per_tile(max_c_src, 2, batch, device)
    mct = _per_tile(max_c_tgt, 2, batch, device)
    return torch.cat([
        _per_tile(stain_matrix_src, 6, batch, device),
        mct / torch.clamp_min(mcs, 1e-8),
        _per_tile(stain_matrix_tgt, 6, batch, device),
        torch.full((batch, 1), regularizer, dtype=torch.float32,
                   device=device),
        torch.zeros((batch, 1), dtype=torch.float32, device=device),
    ], dim=1).contiguous()


def _matrix_apply(x, scal):
    """(B, 3, N) uint8 -> (B, 3, N) uint8, per pixel: K1's OD, the exact
    lasso against the source rows, the rescale, the reconstruction through
    the target rows (``_augment_kernel`` with estimate=False,
    recon_in_scal=True, every pixel gated)."""
    lut = _tables(x.device)[0]
    xl = x.to(torch.long)
    c1, c2 = _lasso2(lut[xl[:, 0]], lut[xl[:, 1]], lut[xl[:, 2]],
                     list(scal[:, 0:3].T), list(scal[:, 3:6].T),
                     scal[:, 14, None])
    return _reconstruct_u8(c1 * scal[:, 6, None], c2 * scal[:, 7, None],
                           scal[:, 8:14])


def normalize_with_matrix_planar_ref(rgb_planar, stain_matrix_src, max_c_src,
                                     stain_matrix_tgt, max_c_tgt,
                                     regularizer: float = 0.01):
    """Plain torch version of the fixed-matrix kernel over planar
    (B, 3, R, 128) uint8 tiles."""
    B, _, R, L = rgb_planar.shape
    scal = _matrix_scalars(stain_matrix_src, max_c_src, stain_matrix_tgt,
                           max_c_tgt, regularizer, B, rgb_planar.device)
    return _matrix_apply(rgb_planar.reshape(B, 3, -1), scal).reshape(
        B, 3, R, L)


def normalize_with_matrix_ref(rgb, stain_matrix_src, max_c_src,
                              stain_matrix_tgt, max_c_tgt,
                              regularizer: float = 0.01):
    """Plain version over (B, H, W, 3) uint8 images of any size."""
    B, H, W, _ = rgb.shape
    scal = _matrix_scalars(stain_matrix_src, max_c_src, stain_matrix_tgt,
                           max_c_tgt, regularizer, B, rgb.device)
    out = _matrix_apply(rgb.reshape(B, H * W, 3).transpose(1, 2), scal)
    return out.transpose(1, 2).reshape(B, H, W, 3)


def _matrix_args(stain_matrix_src, max_c_src, stain_matrix_tgt, max_c_tgt,
                 batch, device):
    """K3's per-image values as ``(tensor, stride)`` pointer arguments: the
    source rows (6 floats), source maxC (2), target rows (6) and target
    maxC (2), each shared (stride 0: the slide-level case) or per image
    (the tiled route's K4 output). Float32 contiguous tensors on
    ``device`` pass through untouched, so the wrapper runs no torch op."""
    return (_pointer_arg(stain_matrix_src, 6, batch, device),
            _pointer_arg(max_c_src, 2, batch, device),
            _pointer_arg(stain_matrix_tgt, 6, batch, device),
            _pointer_arg(max_c_tgt, 2, batch, device))


@kernel_entry("K3")
def _matrix_launch(x, planar: bool, stain_matrix_src, max_c_src,
                   stain_matrix_tgt, max_c_tgt, regularizer: float):
    global matrix_launches
    from stainlib_tpu_torch.kernels import _build

    B, dev = x.shape[0], x.device
    n_pix = _n_pix(x, planar)
    if n_pix >= 2 ** 31:
        raise ValueError(f"the fixed-matrix kernel takes images of under "
                         f"2^31 pixels, got {n_pix}")
    ptrs = _matrix_args(stain_matrix_src, max_c_src, stain_matrix_tgt,
                        max_c_tgt, B, dev)
    out = torch.empty_like(x)
    _build.launch("matrix_normalize_launch", dev, x.data_ptr(),
                  out.data_ptr(),
                  *[v for t, stride in ptrs for v in (t.data_ptr(), stride)],
                  _tables(dev).data_ptr(), B, n_pix, int(planar),
                  regularizer)
    matrix_launches += 1
    return out


def normalize_with_matrix_planar(rgb_planar, stain_matrix_src, max_c_src,
                                 stain_matrix_tgt, max_c_tgt,
                                 regularizer: float = 0.01):
    """Fixed-matrix normalize over planar (B, 3, R, 128) uint8 tiles
    (``macenko_fused.py:936-991``): exact lasso against a fixed per-tile
    (B, 2, 3) or shared (2, 3) source matrix, rescale every stain by
    ``max_c_tgt / max_c_src``, reconstruct through the target matrix.
    On the card, float32 values already on the tiles' device reach the
    kernel by their own pointer. The JAX signature's ``interpret`` has no
    counterpart here."""
    _check(rgb_planar, planar=True)
    args = (stain_matrix_src, max_c_src, stain_matrix_tgt, max_c_tgt,
            regularizer)
    if rgb_planar.device.type == "cpu":
        return normalize_with_matrix_planar_ref(rgb_planar, *args)
    return _matrix_launch(rgb_planar, True, *args)


def normalize_with_matrix(rgb, stain_matrix_src, max_c_src, stain_matrix_tgt,
                          max_c_tgt, regularizer: float = 0.01):
    """(B, H, W, 3) uint8 entry point, any H and W: the apply is per pixel,
    so the kernel reads a whole interleaved field in one launch."""
    _check(rgb, planar=False, lanes=False)
    args = (stain_matrix_src, max_c_src, stain_matrix_tgt, max_c_tgt,
            regularizer)
    if rgb.device.type == "cpu":
        return normalize_with_matrix_ref(rgb, *args)
    return _matrix_launch(rgb, False, *args)


# ---------------------------------------------------------------------------
# K6 and K7: stain augmentation (StainAugmentor, augmenter.py:403-448).
# ---------------------------------------------------------------------------

_AUG_SCAL = 16  # width of the augment kernels' per-image table


def _augment_scalars(stain_matrix, alpha, beta, regularizer: float,
                     luminosity_threshold: float, augment_background: bool,
                     batch, device):
    """The plain augment versions' (B, 16) per-image table,
    ``_augment_kernel``'s ``scal`` layout (``:842-854, :902-914``): [0:6]
    stain rows (zeros for K6, which estimates them), [6:8] alpha, [8:10]
    beta, [10] the lasso regularizer, [11] the linear-luminance threshold
    of ``luminosity_threshold``, [12] the background flag, [13:16] pad."""
    rows = (torch.zeros((batch, 6), dtype=torch.float32, device=device)
            if stain_matrix is None
            else _per_tile(stain_matrix, 6, batch, device))

    def col(v):
        return torch.full((batch, 1), v, dtype=torch.float32, device=device)

    return torch.cat([rows, _per_tile(alpha, 2, batch, device),
                      _per_tile(beta, 2, batch, device), col(regularizer),
                      col(_y_threshold(luminosity_threshold)),
                      col(1.0 if augment_background else 0.0),
                      torch.zeros((batch, 3), dtype=torch.float32,
                                  device=device)], dim=1).contiguous()


def _augment_pixels(od0, od1, od2, mask, h, e, scal):
    """``_augment_kernel``'s per-pixel part (``:797-813``): the exact lasso
    against the rows ``h``/``e`` (3 lists of (B,)), ``C*alpha+beta`` where
    the pixel is tissue or the background flag is set, reconstruction
    through the same rows. (B, N) planes in, (B, 3, N) uint8 out."""
    c1, c2 = _lasso2(od0, od1, od2, h, e, scal[:, 10, None])
    gate = mask | (scal[:, 12, None] > 0.5)
    c1 = torch.where(gate, c1 * scal[:, 6, None] + scal[:, 8, None], c1)
    c2 = torch.where(gate, c2 * scal[:, 7, None] + scal[:, 9, None], c2)
    return _reconstruct_u8(c1, c2, torch.stack(list(h) + list(e), dim=1))


def macenko_augment_planar_ref(rgb_planar, alpha, beta,
                               luminosity_threshold: float = 0.8,
                               angular_percentile: float = 99.0,
                               regularizer: float = 0.01,
                               augment_background: bool = False,
                               n_bisect: int = 14):
    """Plain torch version of K6 over planar (B, 3, R, 128) uint8 tiles,
    step for step ``_augment_kernel`` with ``estimate=True``: K1's Macenko
    estimate on the whole tile, then :func:`_augment_pixels`."""
    B, _, R, L = rgb_planar.shape
    scal = _augment_scalars(None, alpha, beta, regularizer,
                            luminosity_threshold, augment_background, B,
                            rgb_planar.device)
    od0, od1, od2, mask = _od_and_mask(rgb_planar, luminosity_threshold)
    _, h, e = _macenko_rows(od0, od1, od2, mask, angular_percentile,
                            n_bisect)
    return _augment_pixels(od0, od1, od2, mask, h, e, scal).reshape(
        B, 3, R, L)


def macenko_augment_ref(rgb, alpha, beta, **kw):
    """Plain version of K6 over (B, H, W, 3) uint8 tiles."""
    _, H, W, _ = rgb.shape
    return from_planar(macenko_augment_planar_ref(to_planar(rgb), alpha,
                                                  beta, **kw), H, W)


@kernel_entry("K6")
def _aug_launch(x, planar: bool, alpha, beta,
                luminosity_threshold: float = 0.8,
                angular_percentile: float = 99.0, regularizer: float = 0.01,
                augment_background: bool = False, n_bisect: int = 14,
                g: int | None = None):
    """K6 on CUDA tiles at :func:`cluster_plan`'s G (``g`` forces it); alpha
    and beta by pointer and stride (:func:`_pointer_arg`)."""
    global aug_launches, reductions_per_tile
    from stainlib_tpu_torch.kernels import _build

    B, dev = x.shape[0], x.device
    n_pix = _n_pix(x, planar)
    plan = cluster_plan(n_pix, "K6", g, B, sm_count(dev))
    args = staged_args(plan)
    it_angle = max(n_bisect - 4, 8)
    scratch = stage_scratch(plan, B, dev)
    (al, al_stride), (be, be_stride) = (_pointer_arg(alpha, 2, B, dev),
                                        _pointer_arg(beta, 2, B, dev))
    out = torch.empty_like(x)
    pix_stride, ch_stride = (1, n_pix) if planar else (3, 1)
    _build.launch("augment_launch", dev, x.data_ptr(), out.data_ptr(),
                  al.data_ptr(), al_stride, be.data_ptr(), be_stride,
                  _tables(dev).data_ptr(), B, n_pix, pix_stride, ch_stride,
                  _y_threshold(luminosity_threshold), regularizer,
                  int(augment_background),
                  (100.0 - angular_percentile) / 100.0,
                  angular_percentile / 100.0, it_angle, *args,
                  None if scratch is None else scratch.data_ptr())
    aug_launches += 1
    reductions_per_tile = chain_length("K6", args[3], it_angle)
    return out


def macenko_augment_planar(rgb_planar, alpha, beta,
                           luminosity_threshold: float = 0.8,
                           angular_percentile: float = 99.0,
                           regularizer: float = 0.01,
                           augment_background: bool = False,
                           n_bisect: int = 14):
    """Fused ``StainAugmentor`` fit + pop over planar (B, 3, R, 128) uint8
    tiles (``macenko_fused.py:822-871``). ``alpha``/``beta``: (B, 2) or
    (2,) per-image per-stain draws; the caller holds the random draws, as
    ``stain_augment_pop`` does. Per tile: the Macenko estimate on the whole
    tile (angle bisection ``max(n_bisect - 4, 8)`` rounds), the exact
    lasso, tissue-gated ``C*alpha+beta``, reconstruction through the tile's
    own rows. On the card each tile is one cluster of :func:`cluster_plan`'s
    G blocks, and float32 draws already on the tiles' device reach the
    kernel by their own pointer. The JAX signature's ``interpret`` has no
    counterpart here."""
    _check(rgb_planar, planar=True)
    kw = dict(luminosity_threshold=luminosity_threshold,
              angular_percentile=angular_percentile, regularizer=regularizer,
              augment_background=augment_background, n_bisect=n_bisect)
    if rgb_planar.device.type == "cpu":
        return macenko_augment_planar_ref(rgb_planar, alpha, beta, **kw)
    return _aug_launch(rgb_planar, True, alpha, beta, **kw)


def macenko_augment(rgb, alpha, beta, **kw):
    """(B, H, W, 3) uint8 entry point; the kernel reads the interleaved
    bytes directly (the estimate covers the whole tile)."""
    _check(rgb, planar=False)
    if rgb.device.type == "cpu":
        return macenko_augment_ref(rgb, alpha, beta, **kw)
    return _aug_launch(rgb, False, alpha, beta, **kw)


def _augment_apply(x, scal, luminosity_threshold: float):
    """Plain K7 on (B, 3, N) uint8 pixels: K1's OD and tissue mask, then
    :func:`_augment_pixels` against the table's rows."""
    od0, od1, od2, mask = _od_and_mask(x, luminosity_threshold)
    return _augment_pixels(od0, od1, od2, mask, list(scal[:, 0:3].T),
                           list(scal[:, 3:6].T), scal)


def augment_with_matrix_planar_ref(rgb_planar, stain_matrix, alpha, beta,
                                   luminosity_threshold: float = 0.8,
                                   regularizer: float = 0.01,
                                   augment_background: bool = False):
    """Plain torch version of K7 over planar (B, 3, R, 128) uint8 tiles,
    step for step ``_augment_kernel`` with ``estimate=False``."""
    B, _, R, L = rgb_planar.shape
    scal = _augment_scalars(stain_matrix, alpha, beta, regularizer,
                            luminosity_threshold, augment_background, B,
                            rgb_planar.device)
    return _augment_apply(rgb_planar.reshape(B, 3, -1), scal,
                          luminosity_threshold).reshape(B, 3, R, L)


def augment_with_matrix_ref(rgb, stain_matrix, alpha, beta,
                            luminosity_threshold: float = 0.8,
                            regularizer: float = 0.01,
                            augment_background: bool = False):
    """Plain version of K7 over (B, H, W, 3) uint8 images of any size."""
    B, H, W, _ = rgb.shape
    scal = _augment_scalars(stain_matrix, alpha, beta, regularizer,
                            luminosity_threshold, augment_background, B,
                            rgb.device)
    out = _augment_apply(rgb.reshape(B, H * W, 3).transpose(1, 2), scal,
                         luminosity_threshold)
    return out.transpose(1, 2).reshape(B, H, W, 3)


def _augment_args(stain_matrix, alpha, beta, batch, device):
    """K7's per-image values as ``(tensor, stride)`` pointer arguments: the
    2x3 stain rows (6 floats), alpha and beta (2 each), every one shared
    (stride 0) or per image. Float32 contiguous tensors on ``device`` pass
    through untouched, so a caller that holds them there (``StainAugmentor``
    after ``fit``, the draws of ``stain_augment``) pays for no torch op."""
    return (_pointer_arg(stain_matrix, 6, batch, device),
            _pointer_arg(alpha, 2, batch, device),
            _pointer_arg(beta, 2, batch, device))


@kernel_entry("K7")
def _augment_launch(x, planar: bool, stain_matrix, alpha, beta,
                    luminosity_threshold: float, regularizer: float,
                    augment_background: bool):
    global augment_launches
    from stainlib_tpu_torch.kernels import _build

    B, dev = x.shape[0], x.device
    n_pix = _n_pix(x, planar)
    if n_pix >= 2 ** 31:
        raise ValueError(f"the augment-apply kernel takes images of under "
                         f"2^31 pixels, got {n_pix}")
    (rows, rows_stride), (al, al_stride), (be, be_stride) = _augment_args(
        stain_matrix, alpha, beta, B, dev)
    out = torch.empty_like(x)
    _build.launch("augment_apply_launch", dev, x.data_ptr(), out.data_ptr(),
                  rows.data_ptr(), rows_stride, al.data_ptr(), al_stride,
                  be.data_ptr(), be_stride, _tables(dev).data_ptr(), B, n_pix,
                  int(planar), regularizer,
                  _y_threshold(luminosity_threshold), int(augment_background))
    augment_launches += 1
    return out


def augment_with_matrix_planar(rgb_planar, stain_matrix, alpha, beta,
                               luminosity_threshold: float = 0.8,
                               regularizer: float = 0.01,
                               augment_background: bool = False):
    """``StainAugmentor`` pop given per-tile (B, 2, 3) or shared (2, 3)
    stain matrices, over planar (B, 3, R, 128) uint8 tiles
    (``macenko_fused.py:886-929``): OD and tissue mask, the exact lasso
    against the given rows, tissue-gated ``C*alpha+beta``, reconstruction
    through the same rows. The JAX signature's ``interpret`` has no
    counterpart here."""
    _check(rgb_planar, planar=True)
    args = (stain_matrix, alpha, beta)
    kw = dict(luminosity_threshold=luminosity_threshold,
              regularizer=regularizer, augment_background=augment_background)
    if rgb_planar.device.type == "cpu":
        return augment_with_matrix_planar_ref(rgb_planar, *args, **kw)
    return _augment_launch(rgb_planar, True, *args, **kw)


def augment_with_matrix(rgb, stain_matrix, alpha, beta,
                        luminosity_threshold: float = 0.8,
                        regularizer: float = 0.01,
                        augment_background: bool = False):
    """(B, H, W, 3) uint8 entry point, any H and W: the apply is per pixel,
    so the kernel reads a whole interleaved field in one launch."""
    _check(rgb, planar=False, lanes=False)
    args = (stain_matrix, alpha, beta)
    kw = dict(luminosity_threshold=luminosity_threshold,
              regularizer=regularizer, augment_background=augment_background)
    if rgb.device.type == "cpu":
        return augment_with_matrix_ref(rgb, *args, **kw)
    return _augment_launch(rgb, False, *args, **kw)
