#!/usr/bin/env python
"""Measure why per-class flow transfer degrades on shifted centers, on the
PyTorch port.

The port's counterpart of ``scripts/flow_transfer_probe.py``: the same
measurements and JSON keys, from a reference-capacity checkpoint that may
have been saved on any device. Runs on the card unless ``--device cpu``
(or ``--cpu``) is given; bits/dim uses the flow's log-determinant series
with probes from a generator seeded with ``--seed + 1``. Each center's
line also prints the mean |uint8 delta| of the recolored tiles against
their input.

The r4 seg-transfer run (BASELINE.md r4) showed the capacity flow losing
to Macenko at 128^2, with centers 1/3 collapsing to ~0.2 mIoU. The suspect
mechanism: the capacity trainer sampled ONLY template-center tiles, while
the reference trains its flow on the full multi-lab cohort
(``train_img_horo.py:292-302`` builds every center's loader) — so shifted
centers are out-of-distribution for the flow+GMM, and the per-class
responsibilities that drive ``image_dist_transform``
(``train_img_horo.py:815,1015``) mis-assign classes.

Per center this probe measures, for a given checkpoint:

  * bits/dim of the center's tiles under the flow (OOD = higher bpd);
  * gamma sharpness: mean max-responsibility (mushy gamma = broken
    class-conditional transfer);
  * class-usage histogram of argmax(gamma) (collapse/permutation vs the
    template's usage);
  * per-class HSD source-vs-template distance after matching classes;
  * mean |uint8 delta| of the recolored output vs the template's own
    recolor (how violently the transfer rewrites the image);
  * per-class Q-Q affine residual vs the template: fit a,b per channel
    mapping the source class quantiles (p5..p95) onto the template's and
    report the worst-channel RMS residual relative to the template spread.
    This bounds what ANY per-class affine transfer — the reference's
    diagonal (mu, sigma) map at ``train_img_horo.py:815`` or the r4 Monge
    extension — can achieve: a large residual means the within-class shift
    is NON-AFFINE and only re-estimation (Macenko's per-image basis) or a
    nonlinear map can close it.

    python scripts/torch_flow_transfer_probe.py --ckpt flow_cap5k/ckpt
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
    p.add_argument("--ckpt", required=True)
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--tiles", type=int, default=16, help="per center")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--template-tiles", type=int, default=64)
    p.add_argument("--raw-weights", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="flow_transfer_probe")
    p.add_argument("--cohort", default="bl",
                   choices=("bl", "acquisition", "acquisition-clean"),
                   help="synthetic cohort (see data/synthetic.py)")
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
    from stainlib_tpu_torch.data.synthetic import N_CENTERS, center_tiles
    from stainlib_tpu_torch.models import color_eval
    from stainlib_tpu_torch.models.train_flow import (
        encode, init_flow_state, reference_capacity)
    from stainlib_tpu_torch.models.validate_flow import (
        accumulate_template_stats, encode_gamma)
    from stainlib_tpu_torch.ops.colorspace import rgb_to_hsd
    from stainlib_tpu_torch.utils.checkpoint import restore_checkpoint

    dev = _device(args.device)
    cfg = reference_capacity()
    flow, gmm, state, _ = init_flow_state(cfg, args.seed, device=dev)
    state = restore_checkpoint(args.ckpt, state, step=args.step)
    params = state.params if args.raw_weights else state.ema.params
    spectral = state.spectral
    print(f"checkpoint step {int(state.step)}, "
          f"{'raw' if args.raw_weights else 'EMA'} weights", flush=True)

    def to_hsd(tiles):
        return rgb_to_hsd(torch.from_numpy(np.asarray(tiles)).to(dev))

    s = args.size
    tmpl = center_tiles(0, args.template_tiles, s, s, seed=args.seed + 100,
                        cohort=args.cohort)
    tmpl_hsd = to_hsd(tmpl)
    _tstats = accumulate_template_stats(
        flow, gmm, cfg, params, spectral,
        [tmpl_hsd[i:i + args.batch]
         for i in range(0, len(tmpl_hsd), args.batch)])
    mu_t, sd_t = _tstats.mu, _tstats.sigma
    mu_t_h = mu_t.cpu().numpy()

    K = cfg.n_clusters
    PS = np.arange(5, 96, 5)

    def class_quantiles(hsd_np, cls_np):
        """(K, 3, len(PS)) per-class per-channel quantiles; NaN if empty."""
        out = np.full((K, 3, len(PS)), np.nan)
        flat = hsd_np.reshape(-1, 3)
        lab = cls_np.reshape(-1)
        for k in range(K):
            sel = flat[lab == k]
            if len(sel) >= 32:
                out[k] = np.percentile(sel, PS, axis=0).T
        return out

    with torch.no_grad():
        t_cls = [encode_gamma(flow, gmm, params, spectral,
                              tmpl_hsd[i:i + args.batch]).argmax(-1)
                 .cpu().numpy()
                 for i in range(0, len(tmpl_hsd), args.batch)]
    q_tmpl = class_quantiles(tmpl_hsd.cpu().numpy(), np.concatenate(t_cls))

    def qq_affine_resid(q_src):
        """Worst-channel relative RMS residual of the best affine fit from
        the source class quantile curve onto the template's, per class."""
        res = []
        for k in range(K):
            worst = 0.0
            for c in range(3):
                qs, qt = q_src[k, c], q_tmpl[k, c]
                if (not np.isfinite(qs).all() or not np.isfinite(qt).all()
                        or float(qs.std()) < 1e-9):
                    # Empty/degenerate class curve (e.g. a class the center
                    # never uses): no affine fit exists.
                    worst = float("nan")
                    break
                a, b = np.polyfit(qs, qt, 1)
                spread = max(float(qt.std()), 1e-6)
                worst = max(worst,
                            float(np.sqrt(np.mean((a * qs + b - qt) ** 2)))
                            / spread)
            res.append(worst)
        return res

    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    @torch.no_grad()
    def probe(hsd):
        bpd, _, gamma = encode(flow, gmm, params, spectral, cfg, hsd,
                               generator=gen)
        gamma = gamma.permute(0, 2, 3, 1)
        mu_s, sd_s = color_eval.class_color_stats(hsd, gamma)
        out = color_eval.image_dist_transform(hsd, gamma, mu_s, sd_s,
                                              mu_t, sd_t)
        return bpd, gamma, mu_s, out

    os.makedirs(args.out, exist_ok=True)
    report = {}
    for c in range(N_CENTERS):
        tiles = center_tiles(c, args.tiles, s, s, seed=args.seed + 200,
                             cohort=args.cohort)
        bpds, sharp, hist = [], [], np.zeros(K)
        mus, outs, cls_np, hsd_np = [], [], [], []
        for i in range(0, len(tiles), args.batch):
            hsd = to_hsd(tiles[i:i + args.batch])
            bpd, gamma, mu_s, out = probe(hsd)
            g = gamma.cpu().numpy()
            bpds.append(float(bpd.mean()))
            sharp.append(float(g.max(axis=-1).mean()))
            hist += np.bincount(g.argmax(-1).reshape(-1), minlength=K)
            mus.append(mu_s.cpu().numpy())
            outs.append(out.cpu().numpy())
            cls_np.append(g.argmax(-1))
            hsd_np.append(hsd.cpu().numpy())
        hist = hist / hist.sum()
        qq = qq_affine_resid(class_quantiles(np.concatenate(hsd_np),
                                             np.concatenate(cls_np)))
        mu_s_avg = np.mean(mus, axis=0)
        # per-class distance between the center's source stats and the
        # template stats it is mapped onto (same index = the transfer's
        # assumption that class identity is stable across centers)
        d_cls = np.linalg.norm(mu_s_avg - mu_t_h, axis=-1)
        report[f"center{c}"] = {
            "bpd": round(float(np.mean(bpds)), 4),
            "gamma_max_mean": round(float(np.mean(sharp)), 4),
            "class_usage": [round(float(x), 4) for x in hist],
            "src_vs_tmpl_mu_dist": [round(float(x), 4) for x in d_cls],
            "qq_affine_resid": [None if np.isnan(x) else round(x, 4)
                                for x in qq],
        }
        du8 = float(np.mean(np.abs(np.concatenate(outs).astype(np.int16)
                                   - tiles.astype(np.int16))))
        grid = np.concatenate(
            [np.concatenate(list(tiles[:4]), axis=1),
             np.concatenate(list(np.concatenate(outs)[:4]), axis=1)])
        try:
            from PIL import Image
            Image.fromarray(grid).save(
                os.path.join(args.out, f"center{c}_in_out.png"))
        except ImportError:
            pass
        print(f"center {c}: bpd {report[f'center{c}']['bpd']:.3f} "
              f"gamma_max {report[f'center{c}']['gamma_max_mean']:.3f} "
              f"usage {report[f'center{c}']['class_usage']} "
              f"mean |du8| {du8:.3f}", flush=True)

    print(json.dumps(report))
    with open(os.path.join(args.out, "probe.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None):
    return run(parse_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
