"""Synthetic multi-center H&E data with deliberately large stain shift.

The port's own copy of the JAX package's ``data/synthetic.py`` (numpy,
scipy and PIL only; the port imports nothing of the JAX package): every
public function returns the same bytes as the original for the same
arguments.

The reference's flow+GMM headline result is the drop in NMI SD/CV across
scanners/centers after normalization (``dlmodels/color-information/
README.md`` NMI tables, computed by ``train_img_horo.py:865-885``). The real
CAMELYON17 centers are not available to this project, so this module
synthesizes a multi-center cohort whose inter-center stain/brightness shift
is large enough that the raw NMI spread is an order of magnitude above the
published normalized level — giving normalization measurable headroom to
close (the round-1 gap: synthetic data whose raw spread was already at the
published level demonstrated nothing).

Each center has its own stain vectors (hue rotation), concentration gain
(staining strength) and illumination level; within-center tiles share those
parameters, so NMI varies between centers and normalization should collapse
that spread.
"""

from __future__ import annotations

import numpy as np

# Per-center (H-vector, E-vector, concentration gain, illumination).
# Gains/illumination chosen so the raw NMI (median/p95 of tissue mean-RGB)
# differs strongly across centers.
_CENTERS = [
    # center 0: the "template" lab — canonical Ruifrok-ish vectors
    dict(H=(0.65, 0.70, 0.29), E=(0.07, 0.99, 0.11), gain=1.0, illum=1.00),
    # center 1: weak eosin, pale scanner
    dict(H=(0.55, 0.76, 0.35), E=(0.15, 0.90, 0.41), gain=0.45, illum=1.00),
    # center 2: over-stained, dim illumination
    dict(H=(0.72, 0.63, 0.29), E=(0.10, 0.94, 0.33), gain=2.1, illum=0.80),
    # center 3: blue-shifted haematoxylin, strong eosin
    dict(H=(0.60, 0.60, 0.53), E=(0.03, 0.99, 0.14), gain=1.5, illum=0.93),
    # center 4: washed-out
    dict(H=(0.64, 0.72, 0.27), E=(0.09, 0.97, 0.22), gain=0.6, illum=1.05),
]

N_CENTERS = len(_CENTERS)

# --------------------------------------------------------------------------
# The ACQUISITION cohort (round 5): per-center variation that is OUTSIDE the
# Beer-Lambert model class.
#
# Round 4 measured that on the `_CENTERS` cohort Macenko is near-oracle BY
# CONSTRUCTION: the tiles are generated by per-center stain matrices x gain x
# illumination — exactly the model Macenko inverts (BASELINE.md r4 "Why the
# gap cannot close"). The reference's claim for the learned flow is the
# opposite regime: real inter-lab variation is dominated by ACQUISITION
# effects — scanner response curves, sensor saturation, compression, focus —
# that are not Beer-Lambert-affine (``dlmodels/color-information/README.md``
# frames the flow as normalizing "different stain procedures and scanner
# effects"). This cohort models that regime: mild stain-vector variation
# (tempered gains so the r4 uint8-truncation confound — information
# destroyed by clipping, unrecoverable by ANY distribution method — does not
# re-enter) plus a distinct per-center acquisition chain applied in RGB
# AFTER the Beer-Lambert render:
#
#   defocus blur -> chroma-dependent sensor saturation -> per-channel filmic
#   tone curve y = (1+k) x^g / (x^g + k) -> shot-like sensor noise -> JPEG.
#
# A pure per-channel POWER curve would stay inside the model class
# (OD' = g * OD is just a rescaled stain matrix); the filmic knee, the
# chroma compression and JPEG are genuinely non-log-linear — the rank-2
# OD-plane structure Macenko estimates is broken (tested:
# tests/test_synthetic_acquisition.py asserts the third OD singular value).
# Tone curves are monotone per channel, i.e. invertible by distribution-level
# recoloring — the regime where a learned per-class transfer can win.
_ACQ_CENTERS = [
    # center 0: the template lab — canonical stains, near-neutral scanner.
    dict(H=(0.65, 0.70, 0.29), E=(0.07, 0.99, 0.11), gain=1.0, illum=1.00,
         g=(1.0, 1.0, 1.0), k=(1.0, 1.0, 1.0), sat=0.0, blur=0.0,
         noise=0.6, q=92),
    # center 1: weak eosin; bright low-gamma response, warm skew, light JPEG.
    dict(H=(0.55, 0.76, 0.35), E=(0.15, 0.90, 0.41), gain=0.80, illum=1.00,
         g=(0.70, 0.80, 1.00), k=(0.70, 0.85, 1.10), sat=0.9, blur=0.3,
         noise=1.2, q=78),
    # center 2: over-stained; contrasty S-curve scanner, strong compression.
    dict(H=(0.72, 0.63, 0.29), E=(0.10, 0.94, 0.33), gain=1.30, illum=0.97,
         g=(1.60, 1.45, 1.30), k=(1.60, 1.30, 1.00), sat=1.8, blur=0.0,
         noise=0.8, q=55),
    # center 3: blue-shifted H; cool channel-skewed response, defocus.
    dict(H=(0.60, 0.60, 0.53), E=(0.03, 0.99, 0.14), gain=1.15, illum=0.98,
         g=(1.30, 1.00, 0.72), k=(1.40, 1.00, 0.65), sat=0.5, blur=0.8,
         noise=1.5, q=70),
    # center 4: washed-out stains; low-contrast lifted toe, noisy sensor.
    dict(H=(0.64, 0.72, 0.27), E=(0.09, 0.97, 0.22), gain=0.85, illum=1.00,
         g=(0.62, 0.66, 0.72), k=(0.55, 0.60, 0.70), sat=1.2, blur=0.4,
         noise=2.2, q=65),
]

COHORTS = ("bl", "acquisition", "acquisition-clean")


def _filmic(x, g, k):
    """Per-channel scanner response ``y = (1+k) x^g / (x^g + k)`` on
    normalized x in [0, 1] — monotone, fixes y(0)=0, y(1)=1; the knee makes
    it non-log-linear (a pure power law would be Beer-Lambert-equivalent)."""
    xg = np.power(np.maximum(x, 0.0), g)
    return (1.0 + k) * xg / (xg + k)


def _apply_acquisition(img255, p, rng):
    """Float RGB in [0, 255] -> uint8 through one center's acquisition chain
    (optics -> sensor -> response -> noise -> codec)."""
    from io import BytesIO

    from PIL import Image
    from scipy.ndimage import gaussian_filter

    x = np.clip(img255 / 255.0, 0.0, 1.0)
    if p["blur"] > 0:
        x = gaussian_filter(x, sigma=(p["blur"], p["blur"], 0.0),
                            mode="nearest")
    if p["sat"] > 0:
        luma = x @ np.array([0.299, 0.587, 0.114])
        chroma = x - luma[..., None]
        x = luma[..., None] + chroma / (1.0 + p["sat"] * np.abs(chroma) * 4.0)
    g = np.asarray(p["g"], np.float64)
    k = np.asarray(p["k"], np.float64)
    x = _filmic(x, g, k)
    if p["noise"] > 0:
        x = x + (p["noise"] / 255.0) * np.sqrt(np.maximum(x, 1e-3)) \
            * rng.standard_normal(x.shape)
    u8 = np.clip(255.0 * x, 0.0, 255.0).astype(np.uint8)
    if p["q"] < 100:
        buf = BytesIO()
        Image.fromarray(u8).save(buf, format="JPEG", quality=int(p["q"]))
        buf.seek(0)
        u8 = np.asarray(Image.open(buf).convert("RGB"))
    return u8


def _smooth_field(rng, h, w, scale=8):
    """Smooth positive random field in [0, 1] (tissue-like blobs)."""
    small = rng.random((max(h // scale, 1), max(w // scale, 1)))
    ys = np.linspace(0, small.shape[0] - 1, h)
    xs = np.linspace(0, small.shape[1] - 1, w)
    y0 = np.clip(ys.astype(int), 0, small.shape[0] - 2)
    x0 = np.clip(xs.astype(int), 0, small.shape[1] - 2)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    a = small[y0][:, x0]
    b = small[y0][:, x0 + 1]
    c = small[y0 + 1][:, x0]
    d = small[y0 + 1][:, x0 + 1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx)


def center_tiles(center: int, n: int, h: int = 32, w: int = 32,
                 seed: int = 0, background_frac: float = 0.15,
                 cohort: str = "bl"):
    """``n`` uint8 RGB tiles from one synthetic center."""
    return center_tiles_with_masks(center, n, h, w, seed=seed,
                                   background_frac=background_frac,
                                   cohort=cohort)[0]


# Segmentation classes for :func:`center_tiles_with_masks`.
SEG_BACKGROUND, SEG_STROMA, SEG_NUCLEI = 0, 1, 2
N_SEG_CLASSES = 3


def center_tiles_with_masks(center: int, n: int, h: int = 32, w: int = 32,
                            seed: int = 0, background_frac: float = 0.15,
                            cohort: str = "bl"):
    """``n`` uint8 RGB tiles plus per-pixel class masks from one center.

    The masks are derived from the PRE-gain concentration fields, so the
    label of a pixel is a property of the simulated tissue, not of the
    center's staining/illumination — the cross-center transfer setting of
    the reference's segmentation comparison (``dlmodels/color-information/
    README.md`` "Semantic Segmentation Comparison": a segmenter trained on
    one center, deployed on color-shifted inputs). Classes:
    ``SEG_NUCLEI`` where the hematoxylin field is dense, ``SEG_STROMA``
    where tissue is present but H is not dense, ``SEG_BACKGROUND`` for the
    whitespace band and near-empty tissue. Returns
    ``(tiles uint8 (n,h,w,3), masks int32 (n,h,w))``; the tiles are
    bit-identical to :func:`center_tiles` for the same arguments (the mask
    derivation consumes no random draws).

    ``cohort``: ``"bl"`` (default) = the original Beer-Lambert cohort
    (`_CENTERS`); ``"acquisition"`` = the same simulated tissue rendered
    through `_ACQ_CENTERS`' per-center scanner chains (non-Beer-Lambert —
    see the `_ACQ_CENTERS` comment); ``"acquisition-clean"`` = the same
    chains with the information-DESTROYING stages removed (no defocus, no
    sensor noise, no JPEG; tone curves and chroma saturation kept) — the
    mechanism probe separating invertible color variation from degradation
    no color map can undo (BASELINE.md r5). The acquisition chain draws its
    noise from a SEPARATE stream, so masks (and the underlying tissue
    fields) are bit-identical across cohorts for the same arguments."""
    if cohort not in COHORTS:
        raise ValueError(f"cohort must be one of {COHORTS}, got {cohort!r}")
    acq = cohort.startswith("acquisition")
    p = (_ACQ_CENTERS if acq else _CENTERS)[center % N_CENTERS]
    if cohort == "acquisition-clean":
        p = dict(p, blur=0.0, noise=0.0, q=100)
    he = np.stack([np.asarray(p["H"], np.float64),
                   np.asarray(p["E"], np.float64)])
    he /= np.linalg.norm(he, axis=1, keepdims=True)
    rng = np.random.default_rng(seed * 1009 + center)
    arng = np.random.default_rng(seed * 1009 + center + 777_001)
    out = np.empty((n, h, w, 3), np.uint8)
    masks = np.empty((n, h, w), np.int32)
    for i in range(n):
        c_h = 1.6 * _smooth_field(rng, h, w) ** 1.5
        c_e = 1.1 * _smooth_field(rng, h, w) ** 1.2
        # Center-invariant labels from the raw fields (before gain,
        # illumination and the per-pixel jitter below).
        m = np.where(c_h > 0.85, SEG_NUCLEI,
                     np.where(c_h + c_e > 0.55, SEG_STROMA,
                              SEG_BACKGROUND)).astype(np.int32)
        C = np.stack([c_h, c_e], -1) * p["gain"]
        C *= 0.9 + 0.2 * rng.random((h, w, 2))
        img = 255.0 * p["illum"] * np.exp(-(C @ he))
        if background_frac > 0:
            bh = int(round(h * background_frac))
            img[:bh] = 255.0 * p["illum"] - rng.integers(0, 3, (bh, w, 3))
            m[:bh] = SEG_BACKGROUND
        out[i] = (_apply_acquisition(img, p, arng) if acq
                  else np.clip(img, 0, 255).astype(np.uint8))
        masks[i] = m
    return out, masks


def stain_domain_task(n: int, seed: int = 0, correlation: float = 0.95,
                      size: int = 224, stripe_amp: float = 0.35,
                      noise: float = 0.02):
    """Two-domain task whose domain cue is a STAIN RECIPE, not a global
    channel multiplier.

    The tint cue of :func:`two_domain_task` is linearly readable from every
    pixel — far stronger than real inter-lab stain variation, and at
    224x224/MobileNet capacity it defeats gradient reversal outright
    (BASELINE.md round-3 boundary measurement). Here the domains differ
    only by hue-rotated H&E vectors (equal concentration gain and
    illumination — matched brightness), the way the synthetic CAMELYON17
    centers differ (``_CENTERS``); the task is stripe orientation
    modulating the HEMATOXYLIN concentration field, so the label lives in
    stain-space structure, not luminance. Returns
    (images f32 [0,1] (n, size, size, 3), task_labels, domain_labels).
    """
    recipes = [
        dict(H=(0.65, 0.70, 0.29), E=(0.07, 0.99, 0.11)),  # canonical
        dict(H=(0.60, 0.60, 0.53), E=(0.03, 0.99, 0.14)),  # blue-shifted
    ]
    hes = []
    for p in recipes:
        he = np.stack([np.asarray(p["H"], np.float64),
                       np.asarray(p["E"], np.float64)])
        hes.append(he / np.linalg.norm(he, axis=1, keepdims=True))

    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    match = rng.random(n) < correlation
    d = np.where(match, y, 1 - y)
    yy, xx = np.mgrid[0:size, 0:size]
    imgs = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        c_h = 1.3 * _smooth_field(rng, size, size) ** 1.5
        c_e = 0.9 * _smooth_field(rng, size, size) ** 1.2
        period = rng.uniform(8.0, 14.0)
        phase = rng.uniform(0, 2 * np.pi)
        coord = yy if y[i] == 0 else xx
        c_h = c_h * (1.0 + stripe_amp * np.sin(
            2 * np.pi * coord / period + phase))
        C = np.stack([c_h, c_e], -1)
        C = C * (0.9 + 0.2 * rng.random((size, size, 2)))
        img = np.exp(-(C @ hes[d[i]]))
        img += noise * rng.standard_normal(img.shape)
        imgs[i] = np.clip(img, 0.0, 1.0)
    return imgs, y.astype(np.int32), d.astype(np.int32)


def two_domain_task(n: int, seed: int = 0, correlation: float = 0.95,
                    size: int = 63, stripe_contrast: float = 0.03,
                    noise: float = 0.18):
    """Synthetic two-domain classification task with a spurious color cue.

    Task label: stripe orientation (0 = horizontal, 1 = vertical) — a shape
    feature a CNN must work for. Domain label: global color tint
    (0 = red-shifted, 1 = blue-shifted) — a trivially learnable shortcut.
    With ``correlation`` = P(domain == task), a plain classifier latches on
    to the tint and fails when the correlation is inverted at test time;
    gradient-reversal training (``base_experiment_dann.py:78-134``) should
    strip the tint from the features. The default contrast/noise are
    calibrated so a 150-step baseline CNN scores F1 ~0.03 on the
    anti-correlated external test (pure shortcut) while 300 3-phase DANN
    steps at hp_lambda=1 score ~1.0 with the domain probe at chance.
    Returns (images f32 [0,1] of shape (n, size, size, 3), task_labels,
    domain_labels)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    match = rng.random(n) < correlation
    d = np.where(match, y, 1 - y)
    yy, xx = np.mgrid[0:size, 0:size]
    imgs = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        period = rng.uniform(6.0, 10.0)
        phase = rng.uniform(0, 2 * np.pi)
        coord = yy if y[i] == 0 else xx
        stripes = 0.5 + stripe_contrast * np.sin(
            2 * np.pi * coord / period + phase
        )
        img = np.repeat(stripes[..., None], 3, axis=-1)
        tint = (np.array([1.25, 1.0, 0.8]) if d[i] == 0
                else np.array([0.8, 1.0, 1.25]))
        img = img * tint
        img += noise * rng.standard_normal(img.shape)
        imgs[i] = np.clip(img, 0.0, 1.0)
    return imgs, y.astype(np.int32), d.astype(np.int32)


def multi_center_batches(centers, tiles_per_center: int, batch: int,
                         h: int = 32, w: int = 32, seed: int = 0,
                         cohort: str = "bl"):
    """Batched uint8 tiles interleaved across ``centers`` (center labels
    returned alongside) — the synthetic stand-in for the per-center
    CAMELYON17 loaders of ``train_img_horo.py:292-302``."""
    imgs = np.concatenate(
        [center_tiles(c, tiles_per_center, h, w, seed=seed + 7 * c,
                      cohort=cohort)
         for c in centers]
    )
    labels = np.repeat(list(centers), tiles_per_center)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(imgs))
    imgs, labels = imgs[order], labels[order]
    n_full = len(imgs) // batch * batch
    return ([imgs[i : i + batch] for i in range(0, n_full, batch)],
            [labels[i : i + batch] for i in range(0, n_full, batch)])
