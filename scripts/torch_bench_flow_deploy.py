#!/usr/bin/env python
"""Deploy rate of the capacity flow, per transfer, on the card.

The counterpart of ``scripts/bench_flow_deploy.py`` for
``stainlib_tpu_torch``: imgs/s of the deployed recolour step

    uint8 RGB -> HSD -> gamma (the flow's forward, logdet skipped, + GMM)
    -> per-class transfer -> uint8 RGB

at the reference's published capacity, for each transfer, timed with
CUDA events over a chain of ``--iters`` steps after one warm-up step. The
reference's deploy loop prints imgs/s per batch
(``train_img_horo.py:728,862``). The per-batch source statistics are
computed inside the step, as ``validate_flow.deploy`` does (one (mu,
sigma) per batch, ``train_img_horo.py:703-705``), so the quantile
transfers pay their quantile extraction here. A measurement script, not a
benchmark cell.

    python scripts/torch_bench_flow_deploy.py --ckpt flow_capacity/ckpt
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", default="flow_capacity/ckpt",
                   help="torch_train_flow_capacity.py checkpoint directory")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--transfers", default="diag,full,quantile,rgb-quantile")
    p.add_argument("--raw-weights", action="store_true",
                   help="bench the raw (non-EMA) parameters")
    p.add_argument("--out", default="bench_flow_deploy.json")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def run(args):
    import torch

    from stainlib_tpu_torch.data.synthetic import center_tiles
    from stainlib_tpu_torch.models.train_flow import (
        init_flow_state, reference_capacity)
    from stainlib_tpu_torch.models.validate_flow import (
        accumulate_template_stats, encode_gamma, transfer_batch)
    from stainlib_tpu_torch.ops.colorspace import rgb_to_hsd
    from stainlib_tpu_torch.utils.checkpoint import restore_checkpoint

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    cfg = dataclasses.replace(reference_capacity(), image_size=args.size)

    def u8(tiles):
        return torch.from_numpy(tiles).to(dev)

    tmpl_hsd = rgb_to_hsd(u8(center_tiles(0, max(args.batch * 4, 32),
                                          args.size, args.size, seed=100)))
    flow, gmm, state, _ = init_flow_state(
        cfg, 0, sample_hsd=tmpl_hsd[:args.batch], device=dev)
    state = restore_checkpoint(args.ckpt, state)
    params = state.params if args.raw_weights else state.ema.params
    spectral = state.spectral
    print(f"checkpoint step {int(state.step)}, "
          f"{'raw' if args.raw_weights else 'EMA'} weights", flush=True)

    batches = [u8(center_tiles(1, args.batch, args.size, args.size,
                               seed=3 + i)) for i in range(2)]
    results = {}
    for transfer in [t.strip() for t in args.transfers.split(",")
                     if t.strip()]:
        full = transfer == "full"
        composite = transfer in ("full-quantile", "rgb-full-quantile")
        quant = transfer.endswith("quantile")
        q_space = "rgb" if transfer.startswith("rgb-") else "hsd"
        stats = accumulate_template_stats(
            flow, gmm, cfg, params, spectral,
            [tmpl_hsd[i:i + args.batch]
             for i in range(0, len(tmpl_hsd), args.batch)],
            return_cov=full or composite, return_quantiles=quant,
            quantile_space=q_space,
            moment_space=q_space if composite else "hsd")

        def step(batch_u8, stats=stats, q_space=q_space,
                 composite=composite):
            """One deploy batch, uint8 -> uint8."""
            hsd = rgb_to_hsd(batch_u8)
            gamma = encode_gamma(flow, gmm, params, spectral, hsd)
            return transfer_batch(hsd, gamma, stats.mu, stats.sigma, None,
                                  stats.cov, stats.quantiles, q_space,
                                  composite)

        step(batches[0])  # warm-up: cuDNN's algorithm choice
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
        t0 = time.perf_counter()
        for i in range(args.iters):
            out = step(batches[i % 2])
        if cuda:
            ev[1].record()
            torch.cuda.synchronize()
            ms = ev[0].elapsed_time(ev[1]) / args.iters
        else:  # the host clock, where there are no CUDA events
            ms = (time.perf_counter() - t0) * 1e3 / args.iters
        assert out.dtype == torch.uint8 and out.shape == batches[0].shape
        results[transfer] = round(args.batch * 1e3 / ms, 1)
        print(f"{transfer}: {results[transfer]:.1f} imgs/sec ({ms:.2f} ms "
              f"per batch; {args.size}x{args.size}, batch {args.batch})",
              flush=True)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    run(parse_args(sys.argv[1:]))
