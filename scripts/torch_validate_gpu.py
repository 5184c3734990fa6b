#!/usr/bin/env python
"""On-card validation of the port's fused kernels against its functional paths.

The PyTorch/CUDA twin of ``scripts/validate_tpu.py``:

    python scripts/torch_validate_gpu.py [--size 64] [--full] [--device cuda]

Checks, each printing a RESULT line (max uint8 diff against the port's
functional path, share of bytes differing by more than 1) and failing
above max 4 or a share of 1e-2:

  * ``macenko_normalize`` (K1), ``vahadane_normalize`` (K2) and
    ``reinhard_normalize`` (K5) against ``extractive.transform`` and
    ``reinhard.transform``, on 4 tiles of ``--size`` x max(``--size``,
    128) (256x256 with ``--full``);
  * the API's fast configurations on the same tiles: Macenko fs=2 nb=10,
    Vahadane fs=2 it=8 nb=10.

Then THROUGHPUT lines at 256x256 and ``--batch`` tiles (default 128) for
``macenko``, ``macenko-fast``, ``vahadane``, ``vahadane-fast`` and
``reinhard`` through the planar entries (K1, K2, K5), and the fit-once
``vahadane-pop`` through ``augment_with_matrix_planar`` (K7) on per-tile
matrices from ``stain_augment_fit_fused`` (K8): the median time of one step
of a dependent chain of ``--iters`` steps (each step takes the previous
step's output) after a warm-up step. On the card the steps are timed by
CUDA events, and the chain waits behind a 50 ms device sleep so the host
queues every step before the first runs. On the CPU the clock is the host's.

Last, ``parallel.stain_sharded.normalize_batch_sharded(..., fused=True)``
on a world of this process alone (NCCL on the card, gloo on the CPU)
against the direct K1 call: max diff exactly 0. The last line is
``VALIDATE-GPU-OK``, printed only when every check passed.

``--device cpu`` runs the same checks on the kernels' plain versions;
without it a host with no CUDA device raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_MAX, GATE_FRAC = 4, 1e-2  # validate_tpu.py's RESULT gate
MACENKO_FAST = dict(fit_stride=2, n_bisect=10)
VAHADANE_FAST = dict(fit_stride=2, num_iters=8, n_bisect=10)
SLEEP_CYCLES = 100_000_000  # ~50 ms of device sleep at the chain's head


def he_batch(n, h, w, seed=0):
    """Synthetic H&E tiles: ``scripts/validate_tpu.he_batch`` byte for
    byte."""
    rng = np.random.default_rng(seed)
    he = np.array([[0.55, 0.72, 0.42], [0.17, 0.80, 0.57]])
    he /= np.linalg.norm(he, axis=1, keepdims=True)
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    out = []
    for i in range(n):
        C = np.stack([
            np.clip(0.8 + 0.6 * np.sin(yy / 9 + seed + i) * np.cos(xx / 7),
                    0, None),
            np.clip(0.6 + 0.4 * np.cos(yy / 11) * np.sin(xx / 5 + seed + i),
                    0, None),
        ], -1) * (0.9 + 0.2 * rng.random((h, w, 2)))
        img = 255.0 * np.exp(-(C @ he))
        img[: h // 5] = 255 - rng.integers(0, 3, (h // 5, w, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


def u8_diff(got, want):
    """(max |diff|, share of bytes differing by more than 1)."""
    import torch

    d = (torch.as_tensor(got).cpu().to(torch.int16)
         - torch.as_tensor(want).cpu().to(torch.int16)).abs()
    return int(d.max()), float((d > 1).float().mean())


def chain_ms(fn, first, iters: int) -> float:
    """Median ms of one step of a dependent chain of ``iters`` steps (each
    takes the previous step's output) after a warm-up step: CUDA events
    between the steps on the card, behind a device sleep that lets the host
    queue the whole chain first; the host clock on the CPU."""
    import torch

    out = fn(first)
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(iters + 1)]
        torch.cuda._sleep(SLEEP_CYCLES)
        events[0].record()
        for ev in events[1:]:
            out = fn(out)
            ev.record()
        events[-1].synchronize()
        times = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    else:
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn(out)
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def result_pairs(batch, pm, pv, pr):
    """[(label, kernel entry's output, functional path's output)] of the
    RESULT checks on the (B, H, W, 3) uint8 ``batch``, given the Macenko,
    Vahadane and Reinhard fits of the target."""
    from stainlib_tpu_torch.kernels.macenko_fused import macenko_normalize
    from stainlib_tpu_torch.kernels.reinhard_fused import reinhard_normalize
    from stainlib_tpu_torch.kernels.vahadane_fused import vahadane_normalize
    from stainlib_tpu_torch.normalization import extractive, reinhard

    mac = extractive.transform(pm, batch, method="macenko")
    vah = extractive.transform(pv, batch, method="vahadane")
    return [
        ("macenko", macenko_normalize(batch, *pm), mac),
        ("vahadane", vahadane_normalize(batch, *pv), vah),
        ("reinhard", reinhard_normalize(batch, pr.means, pr.stds),
         reinhard.transform(pr, batch)),
        ("macenko-fast (fs=2 nb=10)",
         macenko_normalize(batch, *pm, **MACENKO_FAST), mac),
        ("vahadane-fast (fs=2 it=8 nb=10)",
         vahadane_normalize(batch, *pv, **VAHADANE_FAST), vah),
    ]


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--full", action="store_true",
                   help="compare at 256x256")
    p.add_argument("--batch", type=int, default=128,
                   help="tiles of 256x256 per throughput step")
    p.add_argument("--iters", type=int, default=10,
                   help="steps of each throughput chain")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from stainlib_tpu_torch.api import _device
    from stainlib_tpu_torch.augmentation.functional import (
        stain_augment_fit_fused)
    from stainlib_tpu_torch.kernels.fused_stain import to_planar
    from stainlib_tpu_torch.kernels.macenko_fused import (
        augment_with_matrix_planar, macenko_normalize,
        macenko_normalize_planar)
    from stainlib_tpu_torch.kernels.reinhard_fused import (
        reinhard_normalize_planar)
    from stainlib_tpu_torch.kernels.vahadane_fused import (
        vahadane_normalize_planar)
    from stainlib_tpu_torch.normalization import extractive, reinhard
    from stainlib_tpu_torch.parallel.mesh import make_mesh
    from stainlib_tpu_torch.parallel.stain_sharded import (
        normalize_batch_sharded)

    dev = _device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device {name}", flush=True)
    h = 256 if args.full else args.size
    w = 256 if args.full else max(args.size, 128)
    target = torch.from_numpy(he_batch(1, h, w, seed=1)[0]).to(dev)
    batch = torch.from_numpy(he_batch(4, h, w, seed=2)).to(dev)

    pm = extractive.fit(target, method="macenko")
    pv = extractive.fit(target, method="vahadane")
    pr = reinhard.fit(target)
    for label, got, want in result_pairs(batch, pm, pv, pr):
        mx, frac = u8_diff(got, want)
        print(f"RESULT {label}: max diff {mx}, frac>1 {frac:.5f}", flush=True)
        if not (mx <= GATE_MAX and frac < GATE_FRAC):
            raise AssertionError(f"{label}: max {mx}, frac>1 {frac}")

    big = to_planar(torch.from_numpy(
        he_batch(args.batch, 256, 256, seed=3)).to(dev)).contiguous()
    st = stain_augment_fit_fused(torch.from_numpy(
        he_batch(args.batch, 256, 256, seed=4)).to(dev), method="vahadane")
    alpha0 = torch.full((args.batch, 2), 1.05, device=dev)
    beta0 = torch.full((args.batch, 2), 0.02, device=dev)
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    for label, fn in [
        ("macenko", lambda x: macenko_normalize_planar(x, *pm)),
        ("macenko-fast", lambda x: macenko_normalize_planar(
            x, *pm, **MACENKO_FAST)),
        ("vahadane", lambda x: vahadane_normalize_planar(x, *pv)),
        ("vahadane-fast", lambda x: vahadane_normalize_planar(
            x, *pv, **VAHADANE_FAST)),
        ("reinhard", lambda x: reinhard_normalize_planar(
            x, pr.means, pr.stds)),
        ("vahadane-pop (fit-once)", lambda x: augment_with_matrix_planar(
            x, st.stain_matrix, alpha0, beta0)),
    ]:
        ms = chain_ms(fn, big, args.iters)
        print(f"THROUGHPUT {label}: {args.batch / ms * 1e3:.0f} tiles/s "
              f"({ms:.4f} ms per step of {args.batch} tiles of 256^2, "
              f"median of {args.iters}, {clock}, {name})", flush=True)

    own_group = not dist.is_initialized()
    mesh = make_mesh(1, device=dev.type)
    try:
        sharded = normalize_batch_sharded(mesh, target, batch,
                                          method="macenko", fused=True)
    finally:
        if own_group:
            dist.destroy_process_group()
    mx, _ = u8_diff(sharded, macenko_normalize(batch, *pm))
    print(f"RESULT sharded-fused-vs-direct: max diff {mx}", flush=True)
    if mx != 0:
        raise AssertionError("sharded fused path diverged from direct kernel")
    print("VALIDATE-GPU-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
