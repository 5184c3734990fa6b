"""Synthetic H&E tiles made on the device from a seed: the benchmark's one
traffic generator.

A torch rewrite of the Beer-Lambert model of the port's
``data/synthetic.py`` (its ``_CENTERS`` cohort): each slide belongs to one
of five centres, each centre has its own stain vectors, concentration gain
and illumination, and each slide jitters its centre's vectors and gain by
its own draw. A tile is two smooth concentration fields (a coarse uniform
grid, bilinearly upsampled, raised to a power), a per-pixel jitter of 0.9
to 1.1, ``255 * illum * exp(-C @ [H; E])`` truncated to uint8, and a white
band of background across its top rows.

A traffic mix (``traffic/<name>.json``) sets every parameter. The same
seed gives the same bytes; two seeds give the same work in another order:
each batch holds the same set of background shares (a fixed grid over the
mix's range) and the same count of tiles of each listed centre, each
permuted by the seed.
"""

from __future__ import annotations

import random
from typing import NamedTuple

import torch

# Per-centre (H vector, E vector, concentration gain, illumination): the
# port's ``data/synthetic.py`` ``_CENTERS``.
CENTERS = (
    ((0.65, 0.70, 0.29), (0.07, 0.99, 0.11), 1.0, 1.00),  # the template lab
    ((0.55, 0.76, 0.35), (0.15, 0.90, 0.41), 0.45, 1.00),  # weak eosin
    ((0.72, 0.63, 0.29), (0.10, 0.94, 0.33), 2.1, 0.80),  # over-stained
    ((0.60, 0.60, 0.53), (0.03, 0.99, 0.14), 1.5, 0.93),  # blue-shifted H
    ((0.64, 0.72, 0.27), (0.09, 0.97, 0.22), 0.6, 1.05),  # washed-out
)
FIELD_SCALE = 8  # pixels per cell of the coarse concentration grid
CHUNK = 64  # tiles rendered per call: bounds the generator's scratch memory


class Slides(NamedTuple):
    """Per-slide stain parameters: (S, 2, 3) row-normalized vectors, (S,)
    gains and (S,) illuminations."""

    he: torch.Tensor
    gain: torch.Tensor
    illum: torch.Tensor


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (2 ** 63))
    return g


def make_slides(centers, vector_jitter: float, gain_jitter: float,
                g: torch.Generator, device) -> Slides:
    """One slide per entry of ``centers``: the centre's vectors plus a
    normal jitter of ``vector_jitter`` per component (clamped positive,
    rows normalized), its gain times a uniform factor in ``1 +-
    gain_jitter``."""
    base = torch.tensor([[CENTERS[c][0], CENTERS[c][1]] for c in centers],
                        dtype=torch.float32, device=device)
    he = base + vector_jitter * torch.randn(base.shape, generator=g,
                                            device=device)
    he = torch.clamp_min(he, 0.01)
    he = he / torch.linalg.vector_norm(he, dim=-1, keepdim=True)
    gain = torch.tensor([CENTERS[c][2] for c in centers],
                        dtype=torch.float32, device=device)
    gain = gain * (1.0 + gain_jitter * (2.0 * torch.rand(
        gain.shape, generator=g, device=device) - 1.0))
    illum = torch.tensor([CENTERS[c][3] for c in centers],
                         dtype=torch.float32, device=device)
    return Slides(he, gain, illum)


def render(slides: Slides, slide_of_tile, background, side: int,
           g: torch.Generator):
    """uint8 tiles (n, side, side, 3): tile i from slide
    ``slide_of_tile[i]`` with a background band over the top
    ``round(side * background[i])`` rows."""
    n = len(slide_of_tile)
    dev = slides.he.device
    idx = torch.as_tensor(slide_of_tile, device=dev)
    coarse = max(side // FIELD_SCALE, 2)
    grid = torch.rand((n, 2, coarse, coarse), generator=g, device=dev)
    fields = torch.nn.functional.interpolate(
        grid, size=(side, side), mode="bilinear", align_corners=True)
    c_h = 1.6 * fields[:, 0] ** 1.5
    c_e = 1.1 * fields[:, 1] ** 1.2
    jitter = 0.9 + 0.2 * torch.rand((n, 2, side, side), generator=g,
                                    device=dev)
    gain = slides.gain[idx][:, None, None]
    c_h = c_h * gain * jitter[:, 0]
    c_e = c_e * gain * jitter[:, 1]
    he = slides.he[idx]  # (n, 2, 3)
    od = (c_h[..., None] * he[:, None, None, 0, :]
          + c_e[..., None] * he[:, None, None, 1, :])
    white = 255.0 * slides.illum[idx]
    img = white[:, None, None, None] * torch.exp(-od)
    rows = torch.arange(side, device=dev)
    band = torch.round(torch.as_tensor(background, dtype=torch.float32,
                                       device=dev) * side)
    in_band = rows[None, :] < band[:, None]  # (n, side)
    noise = torch.randint(0, 3, (n, side, side, 3), generator=g, device=dev,
                          dtype=torch.uint8)
    img = torch.where(in_band[:, :, None, None],
                      white[:, None, None, None] - noise, img)
    return torch.clamp(img, 0.0, 255.0).to(torch.uint8)


class Pool(NamedTuple):
    batches: list  # (batch, side, side, 3) uint8 tensors on the device
    background: list  # each batch's background shares, as lists


def make_pool(traffic: dict, seed: int, device) -> Pool:
    """The mix's pool of ``pool_batches`` distinct batches, resident on
    ``device``. Each batch holds ``slides_per_batch`` slides, over the
    listed ``centers`` in turn; with ``shared_slides`` every batch draws its
    tiles from the same slides (one slide for the whole pool: the per-slide
    mix)."""
    side, batch = traffic["tile"], traffic["batch"]
    n_slides = traffic["slides_per_batch"]
    centers = traffic["centers"]
    lo, hi = traffic["background"]
    vj, gj = traffic["vector_jitter"], traffic["gain_jitter"]
    g = _generator(seed, device)
    order = random.Random(seed)
    shares = [lo + (hi - lo) * (i + 0.5) / batch for i in range(batch)]

    def slide_centers():
        cs = [centers[s % len(centers)] for s in range(n_slides)]
        order.shuffle(cs)
        return cs

    shared = (make_slides(slide_centers(), vj, gj, g, device)
              if traffic["shared_slides"] else None)
    batches, backgrounds = [], []
    for _ in range(traffic["pool_batches"]):
        slides = (shared if shared is not None
                  else make_slides(slide_centers(), vj, gj, g, device))
        slide_of_tile = [i % n_slides for i in range(batch)]
        order.shuffle(slide_of_tile)
        bg = list(shares)
        order.shuffle(bg)
        batches.append(torch.cat([
            render(slides, slide_of_tile[i:i + CHUNK], bg[i:i + CHUNK], side,
                   g) for i in range(0, batch, CHUNK)]))
        backgrounds.append(bg)
    return Pool(batches, backgrounds)


def make_target(target: dict, seed: int, device):
    """The configuration's target tile (side, side, 3): one tile of the
    named centre, without jitter, from its own stream of the seed."""
    g = _generator(seed ^ 0x5EED7A46, device)
    slides = make_slides([target["center"]], 0.0, 0.0, g, device)
    return render(slides, [0], [target["background"]], target["side"], g)[0]


def mosaic(pool: Pool, n_tiles: int, seed: int):
    """``n_tiles`` distinct tiles of the pool drawn by the seed, stacked
    into one tall (n_tiles * side, side, 3) image: the slide-level fit's
    input, as the port's ``fit_slide`` stacks its sampled tiles."""
    batch = pool.batches[0].shape[0]
    picks = random.Random(seed ^ 0x3051).sample(
        range(len(pool.batches) * batch), n_tiles)
    tiles = [pool.batches[p // batch][p % batch] for p in picks]
    side = tiles[0].shape[0]
    return torch.stack(tiles).reshape(n_tiles * side, side, 3)
