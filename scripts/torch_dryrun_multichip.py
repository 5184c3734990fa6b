#!/usr/bin/env python
"""Dry run of the PyTorch port's distributed paths on a gloo world of N CPU ranks.

    python scripts/torch_dryrun_multichip.py [N]     # N processes, default 4

The counterpart of ``__graft_entry__.dryrun_multichip`` for
``stainlib_tpu_torch``. It starts N CPU processes, joins them in a gloo
process group over a ``file://`` store in a temporary directory
(``parallel.mesh.initialize_distributed``), builds a 'data' mesh over them
(``make_mesh``) and runs one step of each distributed path:

1. data-parallel tile normalization: the batch sharded over 'data', the
   functional Macenko transform on each rank's rows;
1b. the same through the per-tile kernel's entry (``fused=True``: K1 on a
   CUDA mesh, its plain version here), one tile per rank;
2. the pixel-sharded concentration solve;
3. a data-parallel training step of a small torch model (a two-layer MLP
   on tile colour statistics) through ``collectives.data_parallel_step``:
   each rank's gradients on its rows, averaged over 'data', then an SGD
   update that must leave every rank with the same parameters.

Each rank checks its shapes, types and finiteness; the gathered results
must be the same on every rank. It prints ``DRYRUN_OK world=N`` and exits 0
when every rank passed.

``entry(device="cuda")`` is the twin of ``__graft_entry__.entry``: the
one-card compile check's ``(fn, example_args)``.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180


def _make_tiles(n, h, w, seed=0):
    """Synthetic H&E tiles (``__graft_entry__._make_tiles``'s recipe)."""
    rng = np.random.default_rng(seed)
    he = np.array([[0.55, 0.72, 0.42], [0.17, 0.80, 0.57]])
    he /= np.linalg.norm(he, axis=1, keepdims=True)
    C = rng.random((n, h, w, 2)) * 1.5
    img = 255.0 * np.exp(-(C @ he))
    return np.clip(img, 0, 255).astype(np.uint8)


def entry(device="cuda"):
    """(fn, example_args) for a one-card compile check
    (``__graft_entry__.entry``'s twin): ``fn(params, batch)`` is the port's
    functional Macenko ``extractive.transform`` of 4 tiles of 64x64 toward
    ``extractive.fit`` of one 64x64 target. The arguments live on
    ``device``; without a CUDA device, ``"cuda"`` raises."""
    sys.path.insert(0, ROOT)
    import torch

    from stainlib_tpu_torch.api import _device
    from stainlib_tpu_torch.normalization import extractive

    dev = _device(device)
    target = torch.from_numpy(_make_tiles(1, 64, 64, seed=1)[0]).to(dev)
    params = extractive.fit(target, method="macenko")
    batch = torch.from_numpy(_make_tiles(4, 64, 64, seed=2)).to(dev)

    def fn(params, batch):
        return extractive.transform(params, batch, method="macenko")

    return fn, (params, batch)


def rank_main(rank: int, world: int, store: str) -> None:
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from stainlib_tpu_torch.parallel import collectives as pc
    from stainlib_tpu_torch.parallel.mesh import (
        initialize_distributed, make_mesh, shard_rows)
    from stainlib_tpu_torch.parallel.stain_sharded import (
        normalize_batch_sharded, sharded_concentrations)

    initialize_distributed(f"file://{store}", world, rank, device="cpu")
    try:
        mesh = make_mesh(world, device="cpu", data=world)

        def same_everywhere(x):
            parts = pc.all_gather_metrics(x[None], mesh)
            assert all(torch.equal(p, parts[0]) for p in parts), "ranks differ"

        # 1) Data-parallel tile normalization: batch sharded over 'data'.
        batch = _make_tiles(2 * world, 32, 64, seed=3)
        target = _make_tiles(1, 32, 64, seed=4)[0]
        out = pc.all_gather_metrics(
            normalize_batch_sharded(mesh, target, batch), mesh)
        assert out.shape == batch.shape and out.dtype == torch.uint8
        same_everywhere(out)

        # 1b) The per-tile kernel's entry on each rank's rows, one tile each.
        out_f = pc.all_gather_metrics(normalize_batch_sharded(
            mesh, target, batch[:world], fused=True), mesh)
        assert out_f.shape == batch[:world].shape
        assert out_f.dtype == torch.uint8
        same_everywhere(out_f)

        # 2) Pixel-sharded concentration solve.
        od = np.abs(np.random.default_rng(0).standard_normal(
            (world * 256, 3))).astype(np.float32)
        M = np.array([[0.55, 0.72, 0.42], [0.17, 0.80, 0.57]], np.float32)
        M /= np.linalg.norm(M, axis=1, keepdims=True)
        C = pc.all_gather_metrics(sharded_concentrations(mesh, od, M), mesh)
        assert C.shape == (od.shape[0], 2) and bool(torch.isfinite(C).all())

        # 3) A data-parallel training step: per-rank grads, pmean, update.
        tiles = torch.from_numpy(_make_tiles(8 * world, 16, 16, seed=5))
        x = tiles.float().div(255.0).reshape(len(tiles), -1, 3)
        feats = torch.cat([x.mean(1), x.std(1)], 1)  # (N, 6)
        labels = (feats[:, 0] > feats[:, 0].median()).float()
        g = torch.Generator().manual_seed(0)
        params = {"w1": 0.1 * torch.randn(6, 8, generator=g),
                  "b1": torch.zeros(8), "w2": 0.1 * torch.randn(8, 1,
                                                                generator=g)}

        def loss_fn(p, b):
            xb, yb = b
            h = torch.tanh(xb @ p["w1"] + p["b1"])
            return torch.nn.functional.binary_cross_entropy_with_logits(
                (h @ p["w2"])[:, 0], yb)

        step = pc.data_parallel_step(mesh, loss_fn)
        rows = shard_rows(mesh, "data", feats.shape)
        losses = []
        for _ in range(3):
            loss, grads = step(params, (feats[rows], labels[rows]))
            params = {k: v - 0.5 * grads[k] for k, v in params.items()}
            losses.append(float(loss))
        assert np.isfinite(losses).all(), losses
        for v in params.values():
            same_everywhere(v)
        print(f"rank {rank}: normalize {tuple(out.shape)}, fused "
              f"{tuple(out_f.shape)}, concentrations {tuple(C.shape)}, "
              f"train losses {[round(v, 6) for v in losses]}", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    world = int(argv[0]) if argv else 4
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="torch_dryrun_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=rank_main, args=(r, world, store))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(TIMEOUT_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        print(f"DRYRUN_FAILED world={world} exit codes {codes}", flush=True)
        return 1
    print(f"DRYRUN_OK world={world}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
