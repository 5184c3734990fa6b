#!/usr/bin/env python
"""Downstream segmentation transfer on the PyTorch port: does
normalization help a segmenter?

The port's counterpart of ``scripts/seg_transfer_demo.py``, every flag
kept; ``--device`` (default ``cuda``) picks the device, and ``--cpu`` is
``--device cpu``. The Macenko, Vahadane and Reinhard conditions run the
port's functional ``extractive`` and ``reinhard`` paths (no fused
kernel), as the JAX script runs its functional paths; the flow condition
deploys gamma from the flow's forward with the log-determinant skipped
(``validate_flow.encode_gamma``).

The reference's headline argument for flow-based color normalization is the
"Semantic Segmentation Comparison with DCGMM" table
(``dlmodels/color-information/README.md``): a segmentation network scores
higher validation mIoU on normalized inputs (iResFlow 0.8477 vs DCGMM
0.7928). The segmentation code itself is not vendored in the reference repo
(the numbers come from the paper), so this script reproduces the result's
*shape* on the synthetic multi-center cohort with known-ground-truth masks
(``synthetic.center_tiles_with_masks``): train a small U-Net on the
template center under each input condition (raw / Macenko / Reinhard /
flow+GMM), deploy it on every color-shifted center under the same
condition, and report per-center + cross-center mIoU.

    python scripts/torch_seg_transfer_demo.py --out seg_transfer
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
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--train-tiles", type=int, default=192,
                   help="template-center training tiles")
    p.add_argument("--eval-tiles", type=int, default=32, help="per center")
    p.add_argument("--seg-steps", type=int, default=400)
    p.add_argument("--seg-base", type=int, default=16)
    p.add_argument("--seg-depth", type=int, default=3)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--methods", default="raw,macenko,reinhard,flow",
                   help="comma list of input conditions")
    p.add_argument("--flow-steps", type=int, default=300)
    p.add_argument("--flow-hidden", type=int, default=32)
    p.add_argument("--flow-scales", type=int, default=2)
    p.add_argument("--flow-blocks", type=int, default=2)
    p.add_argument("--flow-clusters", type=int, default=4)
    p.add_argument("--capacity-ckpt", default=None,
                   help="deploy the flow condition from a trained "
                        "reference-capacity checkpoint directory "
                        "(scripts/torch_train_flow_capacity.py) instead of "
                        "training a demo-size flow; uses EMA weights "
                        "unless --flow-raw-weights")
    p.add_argument("--flow-raw-weights", action="store_true",
                   help="with --capacity-ckpt: deploy the raw (non-EMA) "
                        "parameters")
    p.add_argument("--capacity-step", type=int, default=None,
                   help="with --capacity-ckpt: restore this saved step "
                        "instead of most-recent")
    p.add_argument("--class-match", action="store_true",
                   help="rank-match GMM classes to the template's by usage "
                        "share before the per-class transfer (robust to the "
                        "class permutation measured on OOD centers, "
                        "BASELINE.md r4); off = the reference's k->k mapping")
    p.add_argument("--class-match-scope", choices=("batch", "center"),
                   default="batch",
                   help="granularity of --class-match: 'batch' = one perm "
                        "per deploy batch from that batch's own gamma "
                        "(validate_flow.deploy default; r4 measured it "
                        "flipping identity-ordered batches); 'center' = "
                        "pool usage over ALL of a center's tiles and use "
                        "ONE perm per center (the flow_normalize_slide "
                        "slide-level approach)")
    p.add_argument("--transfer",
                   choices=("diag", "full", "quantile", "full-quantile",
                            "rgb-quantile", "rgb-full-quantile"),
                   default="diag",
                   help="per-class transfer: 'diag' = the reference's "
                        "per-channel (mu, sigma) affine "
                        "(train_img_horo.py:815); 'full' = full-covariance "
                        "Gaussian OT (Monge) maps — EXTENSION, rotates "
                        "chroma per class (color_eval.monge_maps); "
                        "'quantile' = per-class quantile matching — "
                        "EXTENSION, closes the measured non-affine "
                        "within-class shifts; 'full-quantile' = Monge "
                        "rotation then quantile correction (BASELINE.md "
                        "r4); 'rgb-quantile' = quantile matching on the "
                        "float-RGB rendering — the space where acquisition "
                        "tone curves are per-channel monotone and exactly "
                        "invertible (BASELINE.md r5); 'rgb-full-quantile' "
                        "= the composite in RGB — the Monge map absorbs "
                        "per-center linear stain MIXING while the quantile "
                        "step inverts the tone curves (BASELINE.md r5)")
    p.add_argument("--src-stats", choices=("batch", "image"),
                   default="batch",
                   help="source statistics pooling for the flow transfer: "
                        "'batch' = the reference's one (mu, sigma) per "
                        "deploy batch (train_img_horo.py:703-705); 'image' "
                        "= per-image (EXTENSION — adapts per image like "
                        "Macenko's re-estimation)")
    p.add_argument("--cohort", default="bl",
                   choices=("bl", "acquisition", "acquisition-clean"),
                   help="synthetic cohort: 'bl' = Beer-Lambert stain shifts "
                        "(Macenko near-oracle by construction, BASELINE.md "
                        "r4); 'acquisition' = non-Beer-Lambert per-center "
                        "scanner chains — the regime the reference's "
                        "published flow>classical ordering claims")
    p.add_argument("--seg-augment", action="store_true",
                   help="train the segmenter on degradation-augmented "
                        "copies of the normalized training tiles (shot-like "
                        "noise, JPEG recompression, mild defocus) — applied "
                        "IDENTICALLY to every condition, with the same "
                        "draws. On the acquisition cohort this isolates "
                        "COLOR normalization quality from residual "
                        "sensor/codec artifacts, which Macenko's rank-2 OD "
                        "reconstruction incidentally removes while "
                        "pixelwise distribution transfers preserve them "
                        "(BASELINE.md r5 mechanism)")
    p.add_argument("--out", default="seg_transfer")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs on the host)")
    p.add_argument("--cpu", action="store_true", help="--device cpu")
    args = p.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    return args


def _make_normalizers(args, tmpl_tiles, log):
    """condition name -> uint8 (B,H,W,3) numpy -> uint8 (B,H,W,3) numpy."""
    import numpy as np
    import torch

    from stainlib_tpu_torch.api import _device
    from stainlib_tpu_torch.normalization import extractive, reinhard

    dev = _device(args.device)
    conds = {}
    methods = [m.strip() for m in args.methods.split(",") if m.strip()]
    known = ("raw", "macenko", "vahadane", "reinhard", "flow")
    unknown = [m for m in methods if m not in known]
    if unknown:
        raise SystemExit(
            f"unknown --methods entries {unknown}; choose from {known}")
    target = torch.from_numpy(
        np.ascontiguousarray(tmpl_tiles).reshape(-1, args.size, 3)).to(dev)

    def on_device(fn):
        return lambda b: fn(torch.from_numpy(np.asarray(b)).to(dev)) \
            .cpu().numpy()

    if "raw" in methods:
        conds["raw"] = lambda b: np.asarray(b)
    for m in ("macenko", "vahadane"):
        if m in methods:
            params = extractive.fit(target, method=m)
            conds[m] = on_device(lambda b, p=params, m=m:
                                 extractive.transform(p, b, method=m))
    if "reinhard" in methods:
        rparams = reinhard.fit(target)
        conds["reinhard"] = on_device(
            lambda b: reinhard.transform(rparams, b))
    if "flow" in methods:
        conds["flow"] = (
            _capacity_flow_recolor(args, tmpl_tiles, log)
            if args.capacity_ckpt
            else _train_flow_recolor(args, tmpl_tiles, log))
    return conds


def _capacity_flow_recolor(args, tmpl_tiles, log):
    """The flow condition from a trained reference-capacity checkpoint
    (502,855 parameters, ``scripts/torch_train_flow_capacity.py``), deployed
    like the NMI evaluation (EMA weights, the reference's ``--ema-val``
    swap, ``train_img_horo.py:668-669``): template stats over the demo's
    template tiles, then per-batch gamma -> per-class HSD transfer. The
    flow is fully convolutional, so the 256-trained weights deploy on
    ``--size`` tiles. The checkpoint restores on any device."""
    from stainlib_tpu_torch.api import _device
    from stainlib_tpu_torch.models.train_flow import (
        init_flow_state, reference_capacity)
    from stainlib_tpu_torch.utils.checkpoint import restore_checkpoint

    cfg = reference_capacity()
    if args.size % (2 ** (cfg.n_scales - 1)):
        raise SystemExit(
            f"--size must be divisible by {2 ** (cfg.n_scales - 1)} "
            f"(the capacity flow's squeeze factor)")
    flow, gmm, state, _ = init_flow_state(cfg, args.seed,
                                          device=_device(args.device))
    state = restore_checkpoint(args.capacity_ckpt, state,
                               step=args.capacity_step)
    params = state.params if args.flow_raw_weights else state.ema.params
    log(f"capacity flow checkpoint: step {int(state.step)}, "
        f"{'raw' if args.flow_raw_weights else 'EMA'} weights")
    return _make_recolor(args, flow, gmm, cfg, params, state.spectral,
                         tmpl_tiles)


def _train_flow_recolor(args, tmpl_tiles, log):
    """Train the flow+GMM on the template center and return a recolor
    closure — the reference's validate/deploy path
    (``train_img_horo.py:658-930``): template stats once, then per batch
    gamma -> per-class color transfer toward the template."""
    import numpy as np
    import torch

    from stainlib_tpu_torch.api import _device
    from stainlib_tpu_torch.models.train_flow import (
        FlowConfig, init_flow_state, make_train_step)
    from stainlib_tpu_torch.ops.colorspace import rgb_to_hsd

    dev = _device(args.device)
    s = args.size
    cfg = FlowConfig(image_size=s, n_scales=args.flow_scales,
                     blocks_per_scale=args.flow_blocks,
                     hidden=args.flow_hidden, n_clusters=args.flow_clusters,
                     warmup_iters=min(100, args.flow_steps // 3))
    tmpl_hsd = rgb_to_hsd(torch.from_numpy(np.asarray(tmpl_tiles)).to(dev))
    flow, gmm, state, tx = init_flow_state(
        cfg, args.seed, sample_hsd=tmpl_hsd[:args.batch], device=dev)
    step_fn = make_train_step(flow, gmm, cfg, tx)
    rng = np.random.default_rng(args.seed)
    for i in range(args.flow_steps):
        sel = torch.as_tensor(rng.integers(0, len(tmpl_hsd), args.batch))
        state, loss = step_fn(state, tmpl_hsd[sel.to(dev)])
        if i % 100 == 0 or i == args.flow_steps - 1:
            log(f"flow step {i}: bpd {float(loss):.4f}")

    return _make_recolor(args, flow, gmm, cfg, state.params, state.spectral,
                         tmpl_tiles)


def _make_recolor(args, flow, gmm, cfg, params, spectral, tmpl_tiles):
    """Shared deploy tail of the two flow conditions: template statistics
    once, then a per-batch ``apply`` closure running the selected transfer.

    ``--class-match-scope center`` attaches a ``begin_group(tiles)`` hook
    that ``run()`` calls once per center: class usage is pooled over ALL of
    the group's tiles and ONE permutation is used for every batch of that
    center (the ``flow_normalize_slide`` slide-level approach); the default
    matches per batch (BASELINE.md r4 measured it flipping
    identity-ordered batches)."""
    import numpy as np
    import torch

    from stainlib_tpu_torch.models import color_eval
    from stainlib_tpu_torch.models.validate_flow import (
        accumulate_template_stats, encode_gamma)
    from stainlib_tpu_torch.ops.colorspace import hsd_to_rgb, rgb_to_hsd

    dev = next(iter(params["gmm"].values())).device

    def to_hsd(tiles_u8):
        return rgb_to_hsd(torch.from_numpy(np.asarray(tiles_u8)).to(dev))

    def gamma_of(hsd):
        return encode_gamma(flow, gmm, params, spectral, hsd)

    tmpl_hsd = to_hsd(tmpl_tiles)
    fq = args.transfer == "full-quantile"
    rfq = args.transfer == "rgb-full-quantile"
    full = args.transfer == "full"
    quant = args.transfer == "quantile"
    rq = args.transfer == "rgb-quantile"
    q_space = "rgb" if (rq or rfq) else "hsd"
    composite = fq or rfq
    stats = accumulate_template_stats(
        flow, gmm, cfg, params, spectral,
        [tmpl_hsd[i:i + args.batch]
         for i in range(0, len(tmpl_hsd), args.batch)],
        return_cov=full or composite,
        return_quantiles=quant or composite or rq,
        quantile_space=q_space,
        moment_space=q_space if composite else "hsd")
    mu_t, sd_t, usage_t = stats.mu, stats.sigma, stats.usage
    cov_t, q_t = stats.cov, stats.quantiles
    per_image = args.src_stats == "image"
    center_scope = args.class_match and args.class_match_scope == "center"

    def transfer_one(hsd, gamma, perm):
        """(B,H,W,3),(B,H,W,K) -> uint8 RGB via the selected transfer,
        with source statistics over the leading batch axis."""
        if perm is None and args.class_match and not center_scope:
            perm = color_eval.match_classes_by_usage(
                color_eval.class_usage(gamma), usage_t)
        if composite:
            xq = hsd if q_space == "hsd" else hsd_to_rgb(hsd)
            mu_s, cov_s = color_eval.class_color_cov(xq, gamma)
            return color_eval.image_dist_transform_full_quantile(
                xq, gamma, mu_s, cov_s, mu_t, cov_t, q_t, perm=perm,
                space=q_space)
        if quant:
            q_s, _ = color_eval.class_channel_quantiles(hsd, gamma)
            return color_eval.image_dist_transform_quantile(
                hsd, gamma, q_s, q_t, perm=perm)
        if rq:
            xq = hsd_to_rgb(hsd)
            q_s, _ = color_eval.class_channel_quantiles(xq, gamma)
            return color_eval.image_dist_transform_quantile(
                xq, gamma, q_s, q_t, perm=perm, space="rgb")
        if full:
            mu_s, cov_s = color_eval.class_color_cov(hsd, gamma)
            return color_eval.image_dist_transform_full(
                hsd, gamma, mu_s, cov_s, mu_t, cov_t, perm=perm)
        mu_s, sd_s = color_eval.class_color_stats(hsd, gamma)
        return color_eval.image_dist_transform(
            hsd, gamma, mu_s, sd_s, mu_t, sd_t, perm=perm)

    @torch.no_grad()
    def recolor(batch_u8, perm=None):
        hsd = to_hsd(batch_u8)
        gamma = gamma_of(hsd)
        if per_image:
            # Per-IMAGE source statistics (EXTENSION — the reference pools
            # one (mu, std) per deploy batch, train_img_horo.py:703-705;
            # per-image adapts like Macenko's per-image re-estimation).
            return torch.cat([transfer_one(hsd[i:i + 1], gamma[i:i + 1],
                                           perm)
                              for i in range(hsd.shape[0])])
        return transfer_one(hsd, gamma, perm)

    group_perm = [None]

    @torch.no_grad()
    def begin_group(tiles_u8):
        """Pool class usage over one center's tiles -> ONE permutation."""
        if not center_scope:
            return
        hsd = to_hsd(tiles_u8)
        w_sum = None
        for i in range(0, len(hsd), args.batch):
            gamma = gamma_of(hsd[i:i + args.batch])
            w = gamma.reshape(-1, gamma.shape[-1]).double().sum(0).float()
            w_sum = w if w_sum is None else w_sum + w
        group_perm[0] = color_eval.match_classes_by_usage(
            w_sum / torch.clamp_min(w_sum.sum(), 1e-12), usage_t)

    def apply(b):
        perm = group_perm[0] if center_scope else None
        return recolor(b, perm).cpu().numpy()

    apply.begin_group = begin_group
    return apply


def _augment_training_set(tiles_u8, masks, seed):
    """Original + degraded copies (sensor noise / JPEG / defocus) of the
    NORMALIZED training tiles, masks repeated alongside — the acquisition
    chain's information-destroying stages (``synthetic._apply_acquisition``)
    replayed as train-time augmentation. A fresh rng from ``seed`` means
    every condition gets the SAME draws, so the comparison stays fair.
    PIL and scipy are imported here, where they are used."""
    from io import BytesIO

    import numpy as np
    from PIL import Image
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed + 31)
    x = tiles_u8 / 255.0
    noisy = x + (2.0 / 255.0) * np.sqrt(np.maximum(x, 1e-3)) \
        * rng.standard_normal(x.shape)
    noisy = np.clip(255.0 * noisy, 0, 255).astype(np.uint8)
    jp = np.empty_like(tiles_u8)
    for i, t in enumerate(tiles_u8):
        buf = BytesIO()
        Image.fromarray(t).save(buf, format="JPEG",
                                quality=int(rng.integers(55, 80)))
        buf.seek(0)
        jp[i] = np.asarray(Image.open(buf).convert("RGB"))
    blurred = np.clip(255.0 * gaussian_filter(
        x, sigma=(0.0, 0.6, 0.6, 0.0)), 0, 255).astype(np.uint8)
    return (np.concatenate([tiles_u8, noisy, jp, blurred]),
            np.concatenate([masks] * 4))


def run(args):
    import numpy as np

    if args.size % (1 << args.seg_depth):
        raise SystemExit(
            f"--size ({args.size}) must be divisible by 2**seg-depth "
            f"({1 << args.seg_depth}): the U-Net halves the field "
            f"seg-depth times and the skip concatenations need the "
            f"upsampled widths to match")

    from stainlib_tpu_torch.api import _device
    from stainlib_tpu_torch.data.synthetic import (
        N_CENTERS, N_SEG_CLASSES, center_tiles_with_masks,
    )
    from stainlib_tpu_torch.models.segmentation import (
        mean_iou, train_segmenter)

    dev = _device(args.device)
    log = lambda m: print(m, flush=True)  # noqa: E731
    s = args.size
    train_tiles, train_masks = center_tiles_with_masks(
        0, args.train_tiles, s, s, seed=args.seed + 100, cohort=args.cohort)
    eval_sets = [center_tiles_with_masks(c, args.eval_tiles, s, s,
                                         seed=args.seed + 200,
                                         cohort=args.cohort)
                 for c in range(N_CENTERS)]

    conds = _make_normalizers(args, train_tiles, log)
    results = {}
    for name, norm in conds.items():
        log(f"== condition: {name}")
        # Per-group hook (flow condition, --class-match-scope center):
        # pools usage over the group's tiles before its batches recolor.
        begin_group = getattr(norm, "begin_group", lambda tiles: None)
        begin_group(train_tiles)
        tr = np.concatenate([norm(train_tiles[i:i + args.batch])
                             for i in range(0, len(train_tiles), args.batch)])
        tr_masks = train_masks
        if args.seg_augment:
            tr, tr_masks = _augment_training_set(tr, train_masks, args.seed)
        predict, _ = train_segmenter(
            tr, tr_masks, steps=args.seg_steps, batch=args.batch,
            base=args.seg_base, depth=args.seg_depth,
            n_classes=N_SEG_CLASSES, seed=args.seed, log=log, device=dev)
        per_center = []
        for c, (tiles, masks) in enumerate(eval_sets):
            begin_group(tiles)
            out = np.concatenate([norm(tiles[i:i + args.batch])
                                  for i in range(0, len(tiles), args.batch)])
            pred = np.concatenate(
                [predict(out[i:i + args.batch]).cpu().numpy()
                 for i in range(0, len(out), args.batch)])
            per_center.append(round(mean_iou(pred, masks, N_SEG_CLASSES), 4))
            log(f"  center {c}: mIoU {per_center[-1]:.4f}")
        results[name] = {
            "per_center": per_center,
            "template_miou": per_center[0],
            "shifted_mean_miou": round(float(np.mean(per_center[1:])), 4),
        }

    summary = {"size": s, "seg_steps": args.seg_steps,
               "cohort": args.cohort,
               "seg_augment": bool(args.seg_augment),
               "conditions": results}
    print(json.dumps(summary))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "seg_transfer.json"), "w") as f:
            json.dump(summary, f, indent=2)
    return summary


def main(argv=None):
    return run(parse_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
