#!/usr/bin/env python
"""Train the residual flow + GMM at the reference's published capacity.

The counterpart of ``scripts/train_flow_capacity.py`` for
``stainlib_tpu_torch``. The reference's headline model is a ~500k-parameter
ResidualFlow on 256x256 patches (``dlmodels/color-information/README.md``:
500,388 parameters; constructor ``train_img_horo.py:324-358`` with
``--idim 128 --kernels 3-1-3``). This script:

  * builds ``train_flow.reference_capacity()`` (502,855 parameters),
  * trains up to ``--steps`` steps on 256x256 synthetic-cohort HSD tiles,
    recording the bits/dim curve, and times the step chain,
  * checkpoints, restores into a fresh state and trains further,
  * reports NMI SD/CV before and after recolouring 256x256 test tiles from
    every synthetic center (the raw NMI from ``tissue_mask``, then
    ``validate`` with ``--ema-val``, ``--class-match`` and ``--transfer``),

and writes ``capacity_summary.json`` under ``--out``. Runs on the card
unless ``--device cpu`` (or ``--cpu``) is given.

    python scripts/torch_train_flow_capacity.py --steps 220 --batch 8
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=220,
                   help="total step target (a resumed run continues up to it)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--resume", action="store_true",
                   help="continue from --out/ckpt's most recent checkpoint")
    p.add_argument("--save-every", type=int, default=0,
                   help="checkpoint every N steps mid-run (0 = end only)")
    p.add_argument("--resume-steps", type=int, default=3)
    p.add_argument("--tiles-per-center", type=int, default=8)
    p.add_argument("--template-tiles", type=int, default=0,
                   help="template pool size (0 = max(4*batch, 32))")
    p.add_argument("--train-centers", default="all",
                   help="comma list of synthetic centers to train on, or "
                        "'all' (default); the reference trains on every "
                        "center's loader (train_img_horo.py:292-302)")
    p.add_argument("--train-pool", type=int, default=0,
                   help="training tiles per center (0 = template pool size)")
    p.add_argument("--cohort", default="bl",
                   choices=("bl", "acquisition", "acquisition-clean"),
                   help="synthetic cohort: 'bl' = Beer-Lambert stain "
                        "shifts; 'acquisition' = per-center scanner chains")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "flow_capacity"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip-eval", action="store_true")
    p.add_argument("--ema-val", action="store_true",
                   help="validate with the EMA parameters (the reference's "
                        "--ema-val swap, train_img_horo.py:668-669)")
    p.add_argument("--class-match", action="store_true",
                   help="usage-rank class matching at deploy; default = "
                        "the reference's k->k mapping")
    p.add_argument("--transfer", default="diag",
                   choices=("diag", "full", "quantile", "rgb-quantile",
                            "full-quantile", "rgb-full-quantile"),
                   help="per-class transfer at deploy (models.color_eval)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--cpu", action="store_true",
                   help="the same as --device cpu")
    args = p.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    return args


def run(args):
    import numpy as np
    import torch

    from stainlib_tpu_torch.data.synthetic import (
        N_CENTERS, center_tiles, multi_center_batches)
    from stainlib_tpu_torch.models.color_eval import nmi, nmi_sd_cv
    from stainlib_tpu_torch.models.train_flow import (
        init_flow_state, make_train_step, reference_capacity)
    from stainlib_tpu_torch.models.validate_flow import validate
    from stainlib_tpu_torch.ops.colorspace import rgb_to_hsd
    from stainlib_tpu_torch.ops.tissue import tissue_mask
    from stainlib_tpu_torch.utils.checkpoint import (
        latest_step, restore_checkpoint, save_checkpoint)

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def to_hsd(rgb):
        return rgb_to_hsd(torch.from_numpy(np.ascontiguousarray(rgb)).to(dev))

    cfg = reference_capacity()
    s = cfg.image_size
    os.makedirs(args.out, exist_ok=True)

    n_tmpl = args.template_tiles or max(args.batch * 4, 32)
    tmpl_tiles = center_tiles(0, n_tmpl, s, s, seed=args.seed + 100,
                              cohort=args.cohort)
    tmpl_hsd = to_hsd(tmpl_tiles)

    # The flow trains on the whole multi-center cohort; the template
    # center is only the transfer's target.
    if args.train_centers.strip() == "all":
        train_centers = list(range(N_CENTERS))
    else:
        train_centers = [int(c) for c in args.train_centers.split(",")]
    per_center = args.train_pool or n_tmpl
    if train_centers == [0]:
        train_hsd = tmpl_hsd
    else:
        train_hsd = torch.cat([tmpl_hsd if c == 0 else to_hsd(center_tiles(
            c, per_center, s, s, seed=args.seed + 100 + 7 * c,
            cohort=args.cohort)) for c in train_centers])
    print(f"training pool: {len(train_hsd)} tiles from centers "
          f"{train_centers}", flush=True)

    flow, gmm, state, tx = init_flow_state(
        cfg, args.seed, sample_hsd=train_hsd[:args.batch], device=dev)
    n_params = sum(p.numel() for part in state.params.values()
                   for p in part.values())
    print(f"params: {n_params} (reference published 500,388)", flush=True)

    step_fn = make_train_step(flow, gmm, cfg, tx)
    rng = np.random.default_rng(args.seed)

    def batch_at(_i):
        sel = torch.from_numpy(rng.integers(0, len(train_hsd), args.batch))
        return train_hsd[sel.to(dev)]

    ckdir = os.path.join(args.out, "ckpt")
    start = 0
    if args.resume:
        if latest_step(ckdir) is None:
            print(f"--resume: no checkpoint under {ckdir}; starting fresh",
                  flush=True)
        else:
            state = restore_checkpoint(ckdir, state)
            start = int(state.step)
            print(f"resumed from step {start}", flush=True)
    if start >= args.steps:
        raise SystemExit(
            f"checkpoint already at step {start} >= --steps {args.steps}")

    # The first step (cuDNN's autotuning included) apart; then the chain.
    sync()
    t_first = time.perf_counter()
    state, loss0 = step_fn(state, batch_at(start))
    sync()
    print(f"first step {time.perf_counter() - t_first:.1f}s "
          f"bpd {float(loss0):.4f}", flush=True)

    losses = [loss0]
    t0 = time.perf_counter()
    for i in range(start + 1, args.steps):
        state, loss = step_fn(state, batch_at(i))
        losses.append(loss)  # stays on the device
        if args.save_every and (i + 1) % args.save_every == 0:
            save_checkpoint(ckdir, state, i + 1)
            print(f"step {i + 1}: bpd {float(loss):.4f} (checkpointed)",
                  flush=True)
    sync()
    dt = time.perf_counter() - t0
    final_bpd = float(losses[-1])
    n_timed = max(args.steps - start - 1, 1)
    imgs_s = n_timed * args.batch / max(dt, 1e-9)
    curve = [round(float(v), 4) for v in losses[::args.log_every]]
    print(f"steps {start + 1}..{args.steps - 1}: {dt:.1f}s = "
          f"{imgs_s:.1f} imgs/s ({dt / n_timed * 1e3:.0f} ms/step)",
          flush=True)
    print(f"bpd curve (every {args.log_every}): {curve}", flush=True)
    print(f"final bpd {final_bpd:.4f}", flush=True)
    assert np.isfinite(final_bpd), "bpd diverged"

    # Checkpoint, restore into a fresh state, train further
    # (train_img_horo.py:421-448, 1149-1165).
    save_checkpoint(ckdir, state, args.steps)
    _, _, fresh, _ = init_flow_state(cfg, args.seed + 7,
                                     sample_hsd=tmpl_hsd[:args.batch],
                                     device=dev)
    restored = restore_checkpoint(ckdir, fresh)
    assert int(restored.step) == int(state.step)
    r_loss = None
    for i in range(args.resume_steps):
        restored, r_loss = step_fn(restored, batch_at(10_000 + i))
    resumed_bpd = float(r_loss) if r_loss is not None else final_bpd
    print(f"resume: {args.resume_steps} further steps, bpd {resumed_bpd:.4f}",
          flush=True)
    assert np.isfinite(resumed_bpd)

    summary = {
        "cohort": args.cohort,
        "params": n_params, "image_size": s, "batch": args.batch,
        "steps": args.steps, "imgs_per_s": round(imgs_s, 1),
        "ms_per_step": round(dt / n_timed * 1e3, 1),
        "bpd_first": round(float(loss0), 4), "bpd_final": round(final_bpd, 4),
        "bpd_resumed": round(resumed_bpd, 4), "bpd_curve": curve,
    }

    if not args.skip_eval:
        # NMI before and after at 256^2 test tiles over every center.
        test_rgb, _ = multi_center_batches(
            range(N_CENTERS), args.tiles_per_center, args.batch, s, s,
            seed=args.seed + 200, cohort=args.cohort)
        raw = []
        for b in test_rgb:
            t = torch.from_numpy(b).to(dev)
            raw += nmi(t, tissue_mask(t).mask).tolist()
        raw_sd, raw_cv = nmi_sd_cv(raw)
        eval_params = (restored.ema.params if args.ema_val
                       else restored.params)
        res = validate(
            flow, gmm, cfg, eval_params, restored.spectral,
            [tmpl_hsd[i:i + args.batch]
             for i in range(0, n_tmpl, args.batch)],
            [to_hsd(b) for b in test_rgb], out_dir=args.out,
            class_match=args.class_match, transfer=args.transfer)
        summary.update({
            "raw_nmi_sd": round(raw_sd, 4), "raw_nmi_cv": round(raw_cv, 4),
            "normalized_nmi_sd": round(res["nmi_sd"], 4),
            "normalized_nmi_cv": round(res["nmi_cv"], 4),
            "sd_reduction": round(raw_sd / max(res["nmi_sd"], 1e-9), 2),
            # The reference's statistic (per-class SD/CV averaged across
            # classes, train_img_horo.py:865-898), before and after.
            "class_nmi_sd_raw": round(res["class_nmi_sd_raw"], 4),
            "class_nmi_cv_raw": round(res["class_nmi_cv_raw"], 4),
            "class_nmi_sd": round(res["class_nmi_sd"], 4),
            "class_nmi_cv": round(res["class_nmi_cv"], 4),
        })

    print(json.dumps(summary), flush=True)
    with open(os.path.join(args.out, "capacity_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    run(parse_args(sys.argv[1:]))
