#!/usr/bin/env python
"""End-to-end usage demo on the PyTorch port: every augmenter and normalizer
on one patch.

The port's counterpart of ``examples/augmentation_demo.py`` (itself the
script counterpart of the reference's ``stainlib_augmentation.ipynb``,
cells 4-15: Grayscale, HED-lighter, Stain augmentation with macenko and
vahadane, via randomize()+transform() and fit()+pop() loops), extended with
the normalizers and the batched functional API. Seeded ``torch.Generator``s
take the place of ``jax.random.PRNGKey``. On the card the 224x224 patch
(392 x 128 pixels) takes the fused kernels through the drop-in API: the
Macenko normalizer K1, Vahadane K2, Reinhard K5 and each stain-augment pop
K7. :func:`build_panels` makes the panels (no matplotlib needed);
:func:`main` saves them as one grid PNG.

  python examples/torch_augmentation_demo.py --out stain_demo.png
  python examples/torch_augmentation_demo.py --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def he_patch(h=224, w=224, seed=0):
    rng = np.random.default_rng(seed)
    he = np.array([[0.55, 0.72, 0.42], [0.17, 0.80, 0.57]])
    he /= np.linalg.norm(he, axis=1, keepdims=True)
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    C = np.stack([
        np.clip(0.8 + 0.6 * np.sin(yy / 19) * np.cos(xx / 17), 0, None),
        np.clip(0.6 + 0.4 * np.cos(yy / 23) * np.sin(xx / 13), 0, None),
    ], -1) * (0.9 + 0.2 * rng.random((h, w, 2)))
    return np.clip(255 * np.exp(-(C @ he)), 0, 255).astype(np.uint8)


def build_panels(device="cuda", seed: int = 0):
    """The demo's panels on ``device``: (list of (224, 224, 3) uint8 numpy
    images, list of titles). ``seed`` seeds every object's generator and
    each batched call's; the same seed gives the same panels."""
    import stainlib_tpu_torch as sl
    from stainlib_tpu_torch.augmentation import functional as F
    from stainlib_tpu_torch.augmentation.hsv import hsv_light

    dev = torch.device(device)
    patch = he_patch(seed=1)
    target = he_patch(seed=2)
    images, titles = [patch], ["original"]

    # --- object API, exactly like the reference notebook -------------------
    aug = sl.HedLighterColorAugmenter(seed=seed, device=dev)
    aug.randomize()
    images.append(aug.transform(patch))
    titles.append("HED lighter (randomize+transform)")

    g = sl.GrayscaleAugmentor(seed=seed, device=dev)
    g.fit(patch)
    images.append(g.pop())
    titles.append("Grayscale (fit+pop)")

    for method in ("macenko", "vahadane"):
        s = sl.StainAugmentor(method, seed=seed, device=dev)
        s.fit(patch)
        images.append(s.pop())
        titles.append(f"Stain augment ({method})")

        n = sl.ExtractiveStainNormalizer(method, device=dev)
        n.fit(target)
        images.append(n.transform(patch))
        titles.append(f"Normalized to target ({method})")

    r = sl.ReinhardStainNormalizer(device=dev)
    r.fit(target)
    images.append(r.transform(patch))
    titles.append("Reinhard")

    # --- batched functional API (the card-first surface) -------------------
    batch = torch.from_numpy(np.stack([patch] * 4)).to(dev)
    for fn, title in ((F.hed_strong, "HED strong (batched)"),
                      (hsv_light, "HSV light (batched)"),
                      (F.rgb_jitter, "RGB jitter (batched)")):
        images.append(fn(batch, torch.Generator().manual_seed(seed))[0]
                      .cpu().numpy())
        titles.append(title)
    return images, titles


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "stain_demo.png"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the functional path)")
    args = ap.parse_args(argv)

    from stainlib_tpu_torch.utils.plot import plot_image_grid

    images, titles = build_panels(args.device)
    path = plot_image_grid(images, titles, cols=4, save_path=args.out)
    print(f"wrote {path} with {len(images)} panels")


if __name__ == "__main__":
    main()
