#!/usr/bin/env python
"""Demonstrate that the flow+GMM normalizer normalizes, on the PyTorch
port.

The port's counterpart of ``scripts/flow_effect_demo.py``. The reference's
headline result is the drop in NMI SD/CV after flow-based color
normalization (``dlmodels/color-information/README.md`` NMI tables;
machinery ``train_img_horo.py:658-930``). On the synthetic multi-center
cohort (``data/synthetic.py``), whose raw inter-center NMI spread is about
4x the published normalized level, this trains the flow+GMM on the
template center and reports NMI SD/CV before and after
``image_dist_transform`` (``validate_flow.validate``). Runs on the card
unless ``--device cpu`` (or ``--cpu``) is given.

    python scripts/torch_flow_effect_demo.py --steps 300 --out flow_effect
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--tiles-per-center", type=int, default=16)
    p.add_argument("--n-scales", type=int, default=2)
    p.add_argument("--blocks", type=int, default=2)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--clusters", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--out", default="flow_effect")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs on the host)")
    p.add_argument("--cpu", action="store_true", help="--device cpu")
    args = p.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    return args


def run(args):
    import numpy as np
    import torch

    from stainlib_tpu_torch.api import _device
    from stainlib_tpu_torch.data.synthetic import (
        N_CENTERS, center_tiles, multi_center_batches,
    )
    from stainlib_tpu_torch.models.color_eval import nmi, nmi_sd_cv
    from stainlib_tpu_torch.models.train_flow import (
        FlowConfig, init_flow_state, make_train_step,
    )
    from stainlib_tpu_torch.models.validate_flow import validate
    from stainlib_tpu_torch.ops.colorspace import rgb_to_hsd
    from stainlib_tpu_torch.ops.tissue import tissue_mask

    dev = _device(args.device)
    s = args.image_size
    # Template loader: the template center only (center 0, the reference's
    # RadboudUMC role); test loader: every center.
    tmpl_tiles = center_tiles(0, args.batch * 2, s, s, seed=args.seed + 100)
    test_batches_rgb, _ = multi_center_batches(
        range(N_CENTERS), args.tiles_per_center, args.batch, s, s,
        seed=args.seed + 200,
    )

    def on_dev(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    # Raw (un-normalized) NMI spread — the "before" column.
    raw_nmis = []
    for b in test_batches_rgb:
        x = on_dev(b)
        raw_nmis += nmi(x, tissue_mask(x).mask).tolist()
    raw_sd, raw_cv = nmi_sd_cv(raw_nmis)

    # Train the flow+GMM on the template center.
    cfg = FlowConfig(image_size=s, n_scales=args.n_scales,
                     blocks_per_scale=args.blocks, hidden=args.hidden,
                     n_clusters=args.clusters, lr=args.lr,
                     warmup_iters=min(100, args.steps // 3))
    tmpl_hsd = rgb_to_hsd(on_dev(tmpl_tiles))
    flow, gmm, state, tx = init_flow_state(
        cfg, args.seed, sample_hsd=tmpl_hsd[: args.batch], device=dev)
    step_fn = make_train_step(flow, gmm, cfg, tx)
    rng = np.random.default_rng(args.seed)
    for i in range(args.steps):
        sel = torch.as_tensor(rng.integers(0, len(tmpl_tiles), args.batch))
        state, loss = step_fn(state, tmpl_hsd[sel.to(dev)])
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i}: bpd {float(loss):.4f}", flush=True)

    # Validate: template stats -> recolor every test batch -> NMI SD/CV.
    res = validate(
        flow, gmm, cfg, state.params, state.spectral,
        [tmpl_hsd[i : i + args.batch]
         for i in range(0, len(tmpl_hsd), args.batch)],
        [rgb_to_hsd(on_dev(b)) for b in test_batches_rgb],
        out_dir=args.out, log=lambda *_: None,
    )

    summary = {
        "raw_nmi_sd": round(raw_sd, 4), "raw_nmi_cv": round(raw_cv, 4),
        "normalized_nmi_sd": round(res["nmi_sd"], 4),
        "normalized_nmi_cv": round(res["nmi_cv"], 4),
        "sd_reduction": round(raw_sd / max(res["nmi_sd"], 1e-9), 2),
        "cv_reduction": round(raw_cv / max(res["nmi_cv"], 1e-9), 2),
        "n_images": len(res["nmi"]), "steps": args.steps,
    }
    print(json.dumps(summary))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "effect_summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    return summary


def main(argv=None):
    return run(parse_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
