#!/usr/bin/env python
"""CLI: residual-flow + GMM colour-model training on the PyTorch port.

The port's counterpart of ``scripts/train_flow.py`` (the entry-point role of
``dlmodels/color-information/train_img_horo.py``). Tiles come from
``--slides`` / ``--xmls`` through the port's ``WsiSampler`` and
``DevicePrefetcher``, and ``ops.colorspace.rgb_to_hsd`` turns them into HSD
on the device; without slides a synthetic H&E stream stands in. Runs on
the card unless ``--device cpu`` is given.

  python scripts/torch_train_flow.py --slides '/data/wsr/*.wsr' \\
      --steps 10000 --image-size 64 --batch 64 --save /tmp/flow_ckpt
  python scripts/torch_train_flow.py --capacity --batch 8 --steps 200
  python scripts/torch_train_flow.py --device cpu --steps 3 --image-size 16 \\
      --batch 4 --n-scales 1 --blocks 1 --hidden 8

``--capacity`` trains ``reference_capacity()`` (the published 256^2 model;
the model flags are then ignored). ``--evaluate`` trains nothing: it
restores the newest checkpoint under ``--save`` and runs ``validate``
(template statistics from the first batch, deploy on the next; the NMI CSV
goes to ``--save``). ``--resume`` continues from the newest
checkpoint under ``--save``; ``--steps`` counts the steps of this run, and
checkpoints are named by the global step. Under torchrun (or with
``--coordinator``, ``--num-processes``, ``--process-id``) the ranks form a
data-parallel mesh: each takes ``--batch / world`` tiles per step and the
gradients are averaged over the ranks.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--slides", help="glob of WSIRAW slides", default=None)
    p.add_argument("--xmls", help="glob of ASAP-XML annotations", default="")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup", type=int, default=1000)
    p.add_argument("--update-freq", type=int, default=1)
    p.add_argument("--n-scales", type=int, default=2)
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--clusters", type=int, default=4)
    p.add_argument("--capacity", action="store_true",
                   help="train reference_capacity() (256^2, 502,855 "
                        "parameters); the model flags are ignored")
    p.add_argument("--save", default="flow_ckpt")
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--evaluate", action="store_true",
                   help="run validate() on --save's checkpoint instead of "
                        "training")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs on the host)")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def synthetic_batches(batch: int, size: int, seed: int):
    """Random two-stain Beer-Lambert tiles: the synthetic H&E stream of
    ``scripts/train_flow.py``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    he = np.array([[0.55, 0.72, 0.42], [0.17, 0.80, 0.57]])
    he /= np.linalg.norm(he, axis=1, keepdims=True)
    while True:
        C = rng.random((batch, size, size, 2)) * 1.5
        yield np.clip(255.0 * np.exp(-(C @ he)), 0, 255).astype(np.uint8)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)

    import torch
    import torch.distributed as dist

    from stainlib_tpu_torch.data.pipeline import DevicePrefetcher
    from stainlib_tpu_torch.data.wsi import SamplerConfig, WsiSampler
    from stainlib_tpu_torch.models.train_flow import (
        FlowConfig, init_flow_state, make_train_step, reference_capacity)
    from stainlib_tpu_torch.ops.colorspace import rgb_to_hsd
    from stainlib_tpu_torch.parallel.collectives import broadcast_from_zero
    from stainlib_tpu_torch.parallel.mesh import (
        initialize_distributed, make_mesh)
    from stainlib_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)
    from stainlib_tpu_torch.utils.meters import RunningAverageMeter, get_logger

    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id, auto="WORLD_SIZE" in os.environ,
                           device=args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    mesh = make_mesh(device=args.device) if world > 1 else None
    log = get_logger("train_flow").info
    dev = (torch.device("cuda", torch.cuda.current_device())
           if torch.device(args.device).type == "cuda"
           else torch.device(args.device))

    if args.capacity:
        cfg = dataclasses.replace(reference_capacity(),
                                  update_freq=args.update_freq)
    else:
        cfg = FlowConfig(
            image_size=args.image_size, n_scales=args.n_scales,
            blocks_per_scale=args.blocks, hidden=args.hidden,
            n_clusters=args.clusters, lr=args.lr, warmup_iters=args.warmup,
            update_freq=args.update_freq)
    if args.batch % world:
        raise SystemExit(f"--batch {args.batch} is not divisible by the "
                         f"{world} ranks")
    local = args.batch // world

    if args.slides:
        sampler = WsiSampler(
            args.slides, args.xmls,
            SamplerConfig(tile=cfg.image_size, batch_size=local),
            seed=args.seed)
        host_batches = (t for t, _ in sampler.train_batches())
    else:
        host_batches = synthetic_batches(local, cfg.image_size,
                                         args.seed + rank)
    batches = DevicePrefetcher(host_batches, depth=2, device=dev)

    def next_hsd():
        return rgb_to_hsd(next(batches))

    first = next_hsd()
    flow, gmm, state, tx = init_flow_state(cfg, args.seed, sample_hsd=first,
                                           device=dev)
    if mesh is not None:  # hvd.broadcast_parameters (train_img_horo.py:452)
        state = state._replace(**broadcast_from_zero(
            {"params": state.params, "spectral": state.spectral,
             "ema": state.ema._replace(params=state.params)}, mesh))
    if args.resume or args.evaluate:
        state = restore_checkpoint(args.save, state)
        log(f"resumed at step {state.step}")
    if args.evaluate:
        from stainlib_tpu_torch.models.validate_flow import validate

        res = validate(flow, gmm, cfg, state.params, state.spectral,
                       [first], [next_hsd()], out_dir=args.save, log=log)
        log(f"NMI sd={res['nmi_sd']:.4f} cv={res['nmi_cv']:.4f}")
        if dist.is_initialized():
            dist.destroy_process_group()
        return res
    n_params = sum(p.numel() for part in state.params.values()
                   for p in part.values())
    log(f"device {dev}, world {world}, {n_params} parameters, "
        f"{cfg.image_size}^2 tiles, batch {args.batch}")

    step_fn = make_train_step(flow, gmm, cfg, tx, mesh=mesh)
    meter = RunningAverageMeter(0.97)
    hsd = first
    saved = None
    for i in range(args.steps):
        state, loss = step_fn(state, hsd)
        meter.update(float(loss))
        if i % 50 == 0 or i == args.steps - 1:
            log(f"step {state.step}: bpd {meter.val:.4f} "
                f"(avg {meter.avg:.4f})")
        if rank == 0 and args.save_every and \
                state.step % args.save_every == 0:
            save_checkpoint(args.save, state, state.step)
            saved = state.step
        if i != args.steps - 1:
            hsd = next_hsd()
    if rank == 0 and saved != state.step:
        save_checkpoint(args.save, state, state.step)
    log("done")
    if dist.is_initialized():
        dist.destroy_process_group()
    return state


if __name__ == "__main__":
    main()
