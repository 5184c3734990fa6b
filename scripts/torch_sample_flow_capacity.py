#!/usr/bin/env python
"""Qualitative samples and the invertibility check at reference capacity.

The counterpart of ``scripts/sample_flow_capacity.py`` for
``stainlib_tpu_torch`` (the reference's ``qualitative_samples.py``): restore
a ``scripts/torch_train_flow_capacity.py`` checkpoint of the published
~500k-parameter 256x256 model, draw latents from the trained GMM mixture,
run the fixed-point ``ResidualFlow.inverse``, save a PNG grid of the
sampled density channels, and report the forward(inverse(z)) round trip's
largest error. Runs on the card unless ``--device cpu`` is given.

    python scripts/torch_sample_flow_capacity.py --ckpt flow_capacity/ckpt
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", default="flow_capacity/ckpt")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--out", default="flow_capacity_samples.png")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from stainlib_tpu_torch.data.synthetic import center_tiles
    from stainlib_tpu_torch.models.sampling import (
        flow_inverse, sample_flow, save_sample_grid)
    from stainlib_tpu_torch.models.train_flow import (
        init_flow_state, reference_capacity)
    from stainlib_tpu_torch.ops.colorspace import rgb_to_hsd
    from stainlib_tpu_torch.utils.checkpoint import restore_checkpoint

    dev = torch.device(args.device)
    cfg = reference_capacity()
    sample_hsd = rgb_to_hsd(torch.from_numpy(center_tiles(
        0, 2, cfg.image_size, cfg.image_size, seed=100)).to(dev))
    flow, _, template, _ = init_flow_state(cfg, args.seed,
                                           sample_hsd=sample_hsd, device=dev)
    state = restore_checkpoint(args.ckpt, template)
    print(f"restored step {int(state.step)}", flush=True)

    variables = {**state.params["flow"], **state.spectral}
    gp = state.params["gmm"]
    gmm_params = {"mu": gp["mu"], "sigma": torch.exp(gp["log_sigma"])}
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    x = sample_flow(flow, variables, args.n, gen, gmm_params=gmm_params)
    assert torch.isfinite(x).all()
    save_sample_grid(args.out, x, cols=args.n)
    print(f"wrote {args.out}", flush=True)

    # Invertibility at capacity: inverse(forward(x)) returns x.
    with torch.no_grad():
        z2, _ = torch.func.functional_call(
            flow, variables, (torch.clamp(x, 1e-4, 1.0 - 1e-4),),
            {"skip_logdet": True})
    x2 = flow_inverse(flow, variables, z2)
    err = float((torch.clamp(x2, 0, 1) - x).abs().max())
    print(json.dumps({"n": args.n, "image_size": cfg.image_size,
                      "roundtrip_max_err": round(err, 6)}), flush=True)
    assert err < 5e-2, err
    return 0


if __name__ == "__main__":
    sys.exit(main())
