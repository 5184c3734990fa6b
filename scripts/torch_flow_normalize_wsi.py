#!/usr/bin/env python
"""Whole-slide colour normalization with the trained residual flow + GMM.

The counterpart of ``scripts/flow_normalize_wsi.py`` for
``stainlib_tpu_torch``: the reference's flow deployment
(``train_img_horo.py:658-930``: template statistics, then the per-class
HSD transfer at ``:815``) applied to every tile of a WSI and written back
as a pyramidal TIFF, with the published-capacity model (502,855
parameters) of ``scripts/torch_train_flow_capacity.py``'s checkpoint.

    python scripts/torch_train_flow_capacity.py --steps 220 --out ckpts
    python scripts/torch_flow_normalize_wsi.py slide.svs out.svs \\
        --ckpt ckpts/ckpt

With no --template, the synthetic center 0 (the training template cohort)
is used; pass a template slide for real use. Runs on the card unless
``--device cpu`` is given; writing the TIFF needs libtiff on the host.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="input slide (.svs/.tif/WSIRAW)")
    ap.add_argument("out", help="output pyramidal TIFF path")
    ap.add_argument("--ckpt", default="flow_capacity/ckpt",
                    help="utils/checkpoint.py directory with the "
                         "reference_capacity() training state")
    ap.add_argument("--template", default=None,
                    help="template slide to sample template tiles from "
                         "(default: synthetic center 0)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--level", type=int, default=0)
    ap.add_argument("--src-tiles", type=int, default=32,
                    help="sampled tiles for the slide-level source stats")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compression", default="jpeg",
                    choices=["none", "lzw", "jpeg", "deflate"])
    ap.add_argument("--quality", type=int, default=90)
    ap.add_argument("--raw-weights", action="store_true",
                    help="deploy with the raw (non-EMA) parameters; the "
                         "default is the reference's --ema-val swap "
                         "(train_img_horo.py:668-669)")
    ap.add_argument("--class-match", action="store_true",
                    help="rank-match the slide's GMM classes to the "
                         "template's by usage share before the transfer; "
                         "default = the reference's k->k mapping")
    ap.add_argument("--transfer",
                    choices=("diag", "full", "quantile", "rgb-quantile"),
                    default="diag",
                    help="per-class transfer: 'diag' = the reference's "
                         "(mu, sigma) affine (train_img_horo.py:815); "
                         "'full' = full-covariance Monge maps; 'quantile' "
                         "= per-class quantile matching; 'rgb-quantile' = "
                         "quantile matching in float RGB")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and the tiles")
    args = ap.parse_args(argv)

    from stainlib_tpu_torch.normalization.slide import flow_normalize_slide

    t0 = time.time()
    last = [0.0]

    def progress(done, total):
        now = time.time()
        if now - last[0] > 5.0 or done == total:
            last[0] = now
            print(f"  {done}/{total} batches ({100.0 * done / total:.0f}%)",
                  flush=True)

    info = flow_normalize_slide(
        args.src, args.out, args.ckpt, template=args.template,
        batch=args.batch, level=args.level, n_src_tiles=args.src_tiles,
        seed=args.seed, compression=args.compression, quality=args.quality,
        progress=progress, use_ema=not args.raw_weights,
        class_match=args.class_match, transfer=args.transfer,
        device=args.device)
    dt = time.time() - t0
    print(f"{info['width']}x{info['height']} ({info['tiles']} tiles, "
          f"{info['levels']} levels) -> {args.out}")
    print(f"flow({info['params']} params, step {info['step']})  "
          f"wall {dt:.1f}s  {info['tiles'] / max(dt, 1e-9):.1f} tiles/s "
          f"end-to-end", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
