#!/usr/bin/env python
"""CLI: stain-adversarial DANN experiment on the PyTorch port.

The port's counterpart of ``scripts/train_dann.py`` (the entry-point role
of ``dlmodels/stain_adversarial_learning/tupac_dann_4reps.py`` /
``tcga_dann_4reps.py``): repetitions of the 3-phase alternating DANN
schedule with best-F1 checkpointing and internal/external test, over
balanced patch generators. Accepts .npy datasets of uint8 patches with
integer labels and domain ids; without them a synthetic set stands in.
Each batch is augmented on the device (``--augment``: the port's
``hed_light``, ``rgb_jitter`` or ``hsv_light``, their draws from a
generator seeded with ``--seed``). Runs on the card unless ``--device cpu``
is given.

  python scripts/torch_train_dann.py --train imgs.npy --labels y.npy \\
      --domains d.npy --val-frac 0.2 --reps 4 --epochs 5 --iters 1000
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train", help=".npy of uint8 patches", default=None)
    p.add_argument("--labels", help=".npy of int task labels", default=None)
    p.add_argument("--domains", help=".npy of int domain ids", default=None)
    p.add_argument("--val-frac", type=float, default=0.2)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--backbone", choices=["cnn", "gap", "mobilenet"],
                   default="cnn")
    p.add_argument("--out", default="stainlib_tpu_dann")
    p.add_argument("--augment", choices=["none", "hed", "rgb", "hsv"],
                   default="hed")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs on the host)")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def synthetic_set(seed: int, n: int = 512):
    """The JAX CLI's smoke data: uint8 63x63 patches whose brightness
    follows the label, three domains."""
    import numpy as np

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    domains = rng.integers(0, 3, n)
    imgs = (rng.random((n, 63, 63, 3)) * 0.3
            + labels[:, None, None, None] * 0.35) * 255
    return imgs.astype(np.uint8), labels, domains


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)

    import numpy as np
    import torch

    from stainlib_tpu_torch.api import _device
    from stainlib_tpu_torch.augmentation import functional as F
    from stainlib_tpu_torch.augmentation.hsv import hsv_light
    from stainlib_tpu_torch.data.generators import balanced_batches
    from stainlib_tpu_torch.models.train_dann import (
        DannConfig, train_dann_experiment)

    dev = _device(args.device)
    if args.train:
        imgs = np.load(args.train)
        labels = np.load(args.labels)
        domains = np.load(args.domains)
    else:  # synthetic smoke data so the script runs anywhere
        imgs, labels, domains = synthetic_set(args.seed)

    n = len(imgs)
    n_val = int(n * args.val_frac)
    n_test = n_val
    val = (imgs[:n_val], labels[:n_val])
    test_i = (imgs[n_val : n_val + n_test], labels[n_val : n_val + n_test])
    test_e = test_i  # external split is dataset-specific; same by default
    tr = slice(n_val + n_test, None)

    aug = {"none": None, "hed": F.hed_light, "rgb": F.rgb_jitter,
           "hsv": hsv_light}[args.augment]
    gen = torch.Generator().manual_seed(args.seed)

    def augment(batch, host_rng):
        if aug is None:
            return batch
        return aug(torch.from_numpy(batch).to(dev), gen)

    mit_gen = balanced_batches(imgs[tr], labels[tr], args.batch,
                               seed=args.seed, augment_fn=augment)
    dom_gen = balanced_batches(imgs[tr], labels[tr], args.batch,
                               groups=domains[tr], seed=args.seed + 1,
                               augment_fn=augment)

    cfg = DannConfig(
        n_domains=int(domains.max()) + 1, lr=args.lr, num_reps=args.reps,
        num_epochs=args.epochs, iters_per_epoch=args.iters,
        warmup_iters=args.warmup, batch_size=args.batch, out_dir=args.out,
    )
    agg, per = train_dann_experiment(cfg, mit_gen, dom_gen, val, test_i,
                                     test_e, seed=args.seed, device=dev)
    print("mean [auc_int f1_int auc_ext f1_ext]:", np.round(agg[0], 4))
    print("std :", np.round(agg[1], 4))
    return agg


if __name__ == "__main__":
    main()
