"""Smoke run of the PyTorch/CUDA port's main paths on one GPU.

    python3 chip_smoke.py

Drives ``stainlib_tpu_torch``'s normalize and stain-augmentation paths on
the card, on uint8 H&E images (random synthetic images from a seed):

* Macenko: the drop-in ``ExtractiveStainNormalizer("macenko")`` and the
  batched ``macenko_normalize`` entry (kernel K1), 256x256 tiles;
* Vahadane: the drop-in ``ExtractiveStainNormalizer("vahadane")``, the
  batched ``vahadane_normalize`` entry (kernel K2) and the two-kernel
  ``vahadane_normalize_planar_2k`` (dictionary kernel K8, then the
  fixed-matrix apply kernel K9), 256x256 tiles;
* large fields: the drop-in Macenko and Vahadane ``transform`` of one
  1024x1024 and one 2048x2048 image, the tiled route (the fit kernel K4
  on the grid subsample for Macenko, then the fixed-matrix kernel K3 on
  the whole field);
* the eigenplane kernel K10 (``eigenplane``, no drop-in caller; the
  moments and the eigen-solve in one launch) on 256x256 tiles, one tile and
  16 tiles of 512x512;
* Reinhard: the drop-in ``ReinhardStainNormalizer`` on one 256x256 image
  and the batched ``reinhard_normalize`` entry (kernel K5) on 256x256 and
  512x512 tiles;
* stain augmentation: ``stain_augment`` on 256 tiles of 256x256, Macenko
  (the fused augment kernel K6) and Vahadane (K8, then the augment-apply
  kernel K7), the drop-in ``StainAugmentor("macenko")`` fit and eight pops
  (K7 per pop), ``stain_augment`` on one 2048x2048 field (the functional
  estimate, then K7 on the whole field), and the torch-only augmenters
  (HED, grayscale, RGB, HSV jitter, the geometric warp) against their CPU
  evaluation;
* the flow's residual-branch kernels F1 (phase 38; ``kernels/flow_branch``:
  pack, branch and gather) at the three scales of ``reference_capacity()``
  (1, 4 and 16 channels at 256x256, 128x128 and 64x64, hidden 128, kernels
  3-1-3), 64 tiles each: against their plain version, a second run, and
  timed against it and against ``x + lipschitz_apply`` (cuDNN);
* whole-slide deployment (phases 41-44): ``normalize_slide`` on a
  16,384x16,384 synthetic WSIRAW slide (4,096 tiles of 256x256) in slide
  mode (K3 once per batch of 64), timed by parts (fit, stream, pyramid,
  write) on the host clock, the stream traced by ``torch.profiler`` (K3's
  device time, the device's idle share); the four kernel routes (K3 slide
  mode, K1, K2 and K5 tile mode) on a 2000x2300 slide against their plain
  versions byte for byte, the functional path's budget and a second run;
  and the four routes end to end at 4096x4096. Where the host has no
  libtiff the TIFF writer is not run (a line says so) and level 0 is read
  from the canvas the stream fills;
* the distributed layer (phases 45-47) on an NCCL world of this process
  alone (``parallel.mesh.make_mesh()``; the cross-rank paths are held by
  gloo in the CPU tests): ``normalize_batch_sharded`` with K1 and K2 on
  256 tiles of 256x256, against the direct kernel call, the plain versions
  and the functional path; ``sharded_concentrations`` and the collectives
  through NCCL; the streaming feed of BASELINE config #5
  (``WsiSampler.train_batches`` -> ``DevicePrefetcher`` -> K1, 96 batches
  of 64 tiles, half from an annotated tumor polygon) off the 16,384^2
  slide, its tiles/s on the host clock, K1's device time and the device's
  idle share from a profiler trace; and ``normalize_slide(mesh=...)`` at
  4096x4096 in slide mode (K3) and tile mode (K1) against the call without
  a mesh;
* the flow + GMM colour model and its trainer (phases 48-51; no kernel of
  K1-K10 runs there: training's convolutions are cuDNN's in float32, and
  the forward with its log-determinant skipped and autograd off runs its
  residual branches on F1 where their shapes allow): a small
  flow on the card against the CPU with the same weights and probes (z,
  delta_logp, the loss, the gradients, one step, the inverse);
  ``reference_capacity()`` (502,855 parameters, 256x256, batch 8 tiles of
  the port's synthetic cohort) for 10 train steps, its first step,
  ms/step and imgs/s by CUDA events, peak memory, a profiler trace of two
  steps (the device's idle share, its five longest activities), two
  replays of three steps (bit-identical or not, and under
  ``cudnn.deterministic`` where not), a checkpoint at step 5 resumed to
  step 6's loss bit for bit, and the inverse on two tiles;
  ``bench.py --config flow``'s shape (32x32, batch 64) in imgs/s; and
  ``scripts/torch_train_flow.py`` on the 16,384^2 slide with its polygon,
  6 steps, then ``--resume``;
* the colour model's deployment and evaluation (phases 52-56; no kernel
  of K1-K10 either: gamma from the flow's forward with the logdet
  skipped, the capacity model's 15 residual branches an encode on F1,
  counted over phases 48-56): ``validate`` with each of the six transfers
  for the small
  flow on the card against the CPU; at ``reference_capacity()`` from the
  10-step checkpoint, its deploy pass and recolour step by CUDA events,
  peak memory, the gamma-only route against ``encode``'s gamma and a
  profiler trace of the diag deploy pass; ``flow_normalize_slide`` on the
  4096^2 slide with four transfers, class matching off and on, timed by
  parts, the diag route twice (the same bytes) and its stream traced;
  ``sample_flow`` at capacity, ``train_toy`` on the card and the toy flow
  against the CPU; ``scripts/torch_train_flow.py --evaluate`` and
  ``scripts/torch_bench_flow_deploy.py``;
* the segmenter and DANN families (phases 57-62; no kernel of K1-K10:
  cuDNN and cuBLAS float32): phase 49's card checkpoint restored on the
  CPU, saved there and restored on the card (the same leaves, gamma and
  next loss bit for bit); the U-Net on the card against the CPU and
  ``train_segmenter`` at the seg demo's widths (base 16, depth 3, 64x64,
  batch 32) in ms per step with peak memory; ``DannCNN`` on the card and
  the CPU against the CPU's float64 step, then its three-phase iteration
  at batch 64; ``MobileNetDann`` (alpha 0.5, its trunk's 829,536
  asserted) at 224x224, batch 64, in imgs/s with peak memory and a traced
  iteration's idle share; the six segmentation and DANN CLIs as
  subprocesses, the probe and ``--capacity-ckpt`` on the card's and the
  CPU-saved checkpoint; ``sliding_window_scores`` with a card model;
* the last modules (phases 63-68): ``utils`` on the card (the stall
  watchdog, ``StepTimer`` around K1 against K1's CUDA-event time, a
  ``utils.profiling.trace`` of K1 with an ``annotate`` region that holds
  all three K1 kernels) and ``Config()``; ``scripts/torch_convert_wsi.py``
  on the 16,384^2 slide (WSIRAW to WSIRAW, every level byte for byte); the
  WSIRAW decode rates of
  ``scripts/torch_bench_host_ingestion.py``; the reference-scale drive
  ``scripts/torch_bench_wsi_scale.py`` at 20,480^2 (6,400 tiles, level 0
  above the 1 GiB RAM-canvas threshold, so the canvas is a disk memmap; K3
  once per batch of 128, 64 tiles against K3's plain version and the
  functional path); the augmentation demo's panels on the card against the
  CPU (K1, K2, K5, K7) and the walkthrough notebook's cells on the card;
  ``scripts/torch_launch_multihost.sh`` through torchrun, NCCL at world 1,
  its checkpoint restored;
* the chip commands (phases 69-71): ``scripts/torch_validate_gpu.py`` at
  its default size and with ``--full`` (each RESULT within max 4 u8 and a
  share > 1 under 1e-2 of the functional path, the sharded route equal to
  the direct kernel, ``VALIDATE-GPU-OK``), ``scripts/torch_probe_kernels.py``'s
  default grid and its ``vahadane-roofline`` family (each variant's
  tiles/s and fidelity, printed as JSON), and
  ``torch_dryrun_multichip.entry()``'s ``fn`` on the card against the same
  call on the CPU (max 1 u8, 99.9% equal); and the whole run's seconds.

It builds the hand-written CUDA kernels from the sources in the checkout,
counts each kernel's launches over its path, holds every kernel against
its plain PyTorch version and against the functional path, checks that two
runs give identical bytes, and times each kernel against its plain version
with CUDA events. The thread-block-cluster kernels K1, K2, K4, K5, K6, K8,
K9 and K10 print their cluster plan (``scripts/torch_cluster_sweep.py``
times K1, K2, K4, K6, K8, K9 and K10 at every cluster size; K1, K5, K6,
K8, K9 and K10 are held to the same bytes at every cluster size here, and
timed alone for 256 tiles, one tile and 16 tiles of 512x512). A profiler
trace shows that K10's entry, and K3's with its values ready on the card,
each run exactly one device kernel.
``StainAugmentor.pop`` is timed on the host clock, and one pop's device
work is listed from a profiler trace. Where ``.runs/parent`` holds a ``git archive`` of the
parent commit, ``scripts/torch_time_trees.py`` times both trees' public
entry points in turns (phase 39) and ``scripts/torch_compare_trees.py``
compares all ten kernels' outputs (phase 40); without it those two phases
are skipped and say so.

Phases print one line each. Before the last line it prints the card's name
and power limit (``nvidia-smi``) and a JSON object describing each kernel:
its launches on its path, its largest difference from its plain version,
its time and the plain version's, K1's, K2's, K3's and K5's launches on the
whole-slide phases (``slide_launches``), K1's, K2's and K3's on phases
45-47 (``sharded_launches``, ``stream_launches``, ``mesh_slide_launches``),
K3's on phase 66 (``scale_launches``) and K1's, K2's, K3's, K5's and K7's
on phase 67's demo and notebook (``example_launches``),
and ``bound_ms``, the least time the card
could take for the same work (the larger of its bytes over 3.35 TB/s and
its float32 operations over 67 TFLOP/s, counted from the shapes of the
timed call and the tissue share of its inputs). F1's entry is for one
deploy encode's 15 branches (5 a scale), its launches those of phases
48-56, its ``library_ms`` the branches' ``x + lipschitz_apply``; the last
line is
``{"ok": true, "device": {...}}``. Any failure raises and the script exits
non-zero; without a CUDA device it exits non-zero and prints no result.
Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 20261016
B, SIDE = 256, 256  # the batched main path: 256 tiles of 256x256
B_LARGE, SIDE_LARGE = 16, 512
FIELDS = (1024, 2048)  # large fields: the API's tiled route
FAST = dict(fit_stride=2, n_bisect=10)  # the API's Macenko knobs at >= 256^2
VFAST = dict(fit_stride=2, num_iters=8, n_bisect=10)  # ... and Vahadane's
REPS = 15
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's device memory rate
F32_OPS_PER_S = 67e12  # its float32 rate outside the tensor cores

# float32 operations per pixel visit, counted from the algorithms'
# expressions, each intermediate computed once (a table lookup counts as
# none, an exp as one): the tissue mask (two adds, a compare), the masked
# moments (3 sums, 6 products, 6 sums), the pseudo-angle, the min/max pass,
# one bisection round of one search (a compare, an add), one successor
# recovery (a compare, a min, an add), the exact K=2 lasso, the augment gate,
# the three-channel reconstruction, one BCD pass (a lasso, 9 products, 9
# sums) and Reinhard's per-pixel LAB round trip with its sums.
OPS = dict(mask=3, moments=15, angle=16, extreme=2, round=2, succ=3,
           lasso=38, gate=5, recon=24, bcd=56, reinhard=111)


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def synth_module():
    """``tests/synth.py``, loaded by path (another installed ``tests``
    package may shadow the repo's)."""
    path = Path(__file__).resolve().parent / "tests" / "synth.py"
    spec = importlib.util.spec_from_file_location("stain_synth", path)
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    return synth


def tiles(n, side, seed):
    """Synthetic H&E tiles from ``tests/synth.py``."""
    return synth_module().he_batch(n, side, side, seed=seed)


def compare(got, want):
    """(max |diff|, share of bytes that differ, share differing by > 1)."""
    d = (got.to(torch.int16) - want.to(torch.int16)).abs()
    return (int(d.max()), float((d > 0).float().mean()),
            float((d > 1).float().mean()))


def time_ms(fn, reps=REPS):
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, kernel: str, reps=REPS):
    """Device time per launch of the CUDA kernels whose name contains
    ``kernel``, from ``torch.profiler`` over ``reps`` calls after a warm-up:
    the kernel alone, without the wrapper's host work. Before each call a
    128 MB write evicts the 50 MB L2, so the kernel reads its input from
    device memory, as a caller with fresh tiles would. The time is over the
    launches the profiler recorded, which is the time per call where ``fn``
    launches the kernel once; a count other than ``reps`` (a short window
    can lose some, an ``fn`` can launch several) is logged. None where two
    traces in a row report no device time."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a trace now and then comes back without the kernel
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    flush.fill_(0)
                    fn()
                torch.cuda.synchronize()
        except RuntimeError as err:  # no CUPTI: say so, time with events only
            log("profiler", f"unavailable: {err}")
            return None
        found = [e for e in prof.key_averages() if kernel in e.key]
        us = sum(getattr(e, "device_time_total", 0.0) for e in found)
        if us > 0:
            count = sum(e.count for e in found)
            if count != reps:
                log("profiler", f"{kernel}: {count} launches recorded in "
                                f"{reps} calls; the time is per launch")
            return us / count / 1e3
    return None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def pop_ms(aug, pops: int = 64, warm: int = 8) -> float:
    """Median host-clock time of one ``aug.pop()`` in ms, its copy-out and
    a synchronize included, over ``pops`` pops after ``warm``."""
    times = []
    for i in range(warm + pops):
        t0 = time.perf_counter()
        aug.pop()
        torch.cuda.synchronize()
        if i >= warm:
            times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def time_host_us(fn, reps: int = 2000) -> float:
    """Mean host-clock time of ``fn()`` in microseconds over ``reps``."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def device_events(fn, calls: int = 3) -> list:
    """Names and counts of the device activities (kernels, copies) of
    ``calls`` calls of ``fn()``, from ``torch.profiler``. A short window can
    lose the activities of its first call, so a count may fall short of
    ``calls``; every kind of activity shows in the later ones. Empty where
    the profiler reports none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
    return [f"{e.key} x{e.count}" for e in prof.key_averages()
            if getattr(e, "device_time_total", 0.0) > 0]


def time_pair(kernel, plain):
    """Kernel and plain version in turns (plain, kernel, kernel, plain);
    returns ((kernel a, kernel b), (plain a, plain b)) in ms."""
    pa = time_ms(plain)
    ka = time_ms(kernel)
    kb = time_ms(kernel)
    pb = time_ms(plain)
    return (ka, kb), (pa, pb)


def _est_ops(n, it_angle, tissue):
    """The Macenko estimate over n sample pixels, a share ``tissue`` of
    them in the mask: the mask of every pixel; moments, angle, min/max, two
    searches of ``it_angle`` rounds and two successors over the tissue."""
    return n * (OPS["mask"] + tissue * (
        OPS["moments"] + OPS["angle"] + OPS["extreme"]
        + 2 * it_angle * OPS["round"] + 2 * OPS["succ"]))


def _conc_ops(n, it_conc):
    """The two 99th-percentile concentration searches over n pixels."""
    return n * (OPS["extreme"] + 2 * it_conc * OPS["round"] + 2 * OPS["succ"])


def work(kernel: str, b: int, n: int, tissue: float = 1.0):
    """(bytes, float32 operations) of one call of ``kernel`` on ``b``
    images of ``n`` pixels, a share ``tissue`` of them in the tissue mask,
    at the knobs its timed call uses: each input byte read once, each
    output byte written once."""
    io = 2 * b * n * 3  # uint8 in and out
    s = n // 2  # the fs=2 estimation sample
    t = tissue
    apply = OPS["lasso"] + 2 + OPS["recon"]
    per = {
        "K1": (io, _est_ops(s, 8, t) + n * apply + _conc_ops(s, 10)),
        "K2": (io, _est_ops(s, 8, t) + 8 * t * s * OPS["bcd"] + n * apply
               + _conc_ops(s, 10)),
        "K8": (b * n * 3 + b * 24,
               _est_ops(n, 10, t) + 12 * t * n * OPS["bcd"]),
        "K9": (io + b * 24, n * apply + _conc_ops(n, 14)),
        "K3": (io, n * apply),
        "K4": (b * n * 3 + b * 32,
               _est_ops(n, 10, t) + n * OPS["lasso"] + _conc_ops(n, 14)),
        "K10": (b * n * 3 + b * 24,
                n * (OPS["mask"] + t * OPS["moments"])),
        "K5": (io, n * OPS["reinhard"]),
        "K6": (io, _est_ops(n, 10, t)
               + n * (OPS["lasso"] + OPS["gate"] + OPS["recon"])),
        "K7": (io + b * 24, n * (OPS["mask"] + OPS["lasso"] + OPS["gate"]
                                 + OPS["recon"])),
    }
    n_bytes, ops = per[kernel]
    return n_bytes, ops * b


def bound(kernel: str, b: int, n: int, tissue: float = 1.0) -> dict:
    """``bound_ms`` and ``bound_by`` of :func:`work`."""
    n_bytes, ops = work(kernel, b, n, tissue)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def ptxas_summary(build_log: str) -> str:
    """'kernel: N regs, spill S/L B' for each kernel ptxas reported."""
    out, name = [], None
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)", m.group(1))
            name = k.group(1) if k else m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            spill = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name}: {m.group(1)} regs, spill {spill} B")
            name = None
    return "; ".join(out)


def augment_phases(dev, smi, batch, batch_np, planar, big512) -> list:
    """Phases 30-36: the stain-augmentation paths and the torch-only
    augmenters. Returns the ``kernels`` entries of K6 and K7."""
    import stainlib_tpu_torch as st
    from stainlib_tpu_torch.augmentation import functional as AF
    from stainlib_tpu_torch.augmentation import geometric as AG
    from stainlib_tpu_torch.augmentation import hsv as AH
    from stainlib_tpu_torch.extraction.macenko import stain_matrix_macenko
    from stainlib_tpu_torch.kernels import fused_stain as fs
    from stainlib_tpu_torch.kernels import macenko_fused as mf
    from stainlib_tpu_torch.kernels import vahadane_fused as vf

    def gen(k):
        return torch.Generator().manual_seed(SEED + k)

    def draws(k, lead):
        """The draws ``stain_augment`` makes from ``gen(k)``."""
        return AF._stain_draws(gen(k), lead, 0.2, 0.2, dev)

    def budget(got, want):
        """(max, share > 1) against the functional path; gate <=1 u8 on
        >99% of bytes, max <=4 (tests/test_macenko_fused.py:82-83,
        tests/test_vahadane_fused.py:73-74)."""
        mx, _, over1 = compare(got.cpu(), want)
        assert mx <= 4 and over1 < 1e-2, (mx, over1)
        return mx, over1

    batch_cpu = batch.cpu()

    # The Macenko path, counted: stain_augment on B tiles (K6).
    mf.aug_launches = mf.augment_launches = 0
    mac = AF.stain_augment(batch, gen(30), "macenko")
    torch.cuda.synchronize()
    k6_launches, k7_stray = mf.aug_launches, mf.augment_launches

    # 30. K6 against its plain version; determinism.
    assert (k6_launches, k7_stray) == (1, 0), (k6_launches, k7_stray)
    assert mac.shape == batch.shape and mac.dtype == torch.uint8
    alpha, beta = draws(30, (B,))
    mx30, share30, _ = compare(mac, mf.macenko_augment_ref(batch, alpha,
                                                           beta))
    assert mx30 <= 1 and share30 < 1e-3, (mx30, share30)
    assert torch.equal(AF.stain_augment(batch, gen(30), "macenko"), mac)
    log(30, f"stain_augment('macenko') B={B} {SIDE}^2: main-path launches "
            f"K6={k6_launches} K7={k7_stray}; K6 vs plain max={mx30} u8, "
            f"share differing={share30:.3e} (gate: max<=1, share<1e-3); "
            f"rerun identical")

    k6_shapes = ((f"B={B} {SIDE}^2", batch, alpha, beta),
                 (f"B={B_LARGE} {SIDE_LARGE}^2", big512,
                  *draws(36, (B_LARGE,))),
                 (f"B=1 {SIDE}^2", batch[:1].contiguous(), alpha[:1],
                  beta[:1]))
    for label, x, a6, b6 in k6_shapes:
        want = mf.macenko_augment_ref(x, a6, b6)
        pl = fs.to_planar(x).contiguous()
        for g in mf.CLUSTER_SIZES:
            assert torch.equal(mf._aug_launch(x, False, a6, b6, g=g),
                               want), (label, g)
            assert torch.equal(mf._aug_launch(pl, True, a6, b6, g=g),
                               fs.to_planar(want)), (label, g)
        assert torch.equal(mf.macenko_augment(x, a6, b6), want), label
        n6 = x.shape[1] * x.shape[2]
        log(30, f"K6 {label}: clusters of {list(mf.CLUSTER_SIZES)} blocks "
                f"per tile, interleaved and planar, and the plan's each "
                f"byte-identical to the plain version; "
                f"{plan_text('K6', n6, None, x.shape[0])}")

    # 31. K6 against the functional fit + pop on the CPU, same draws.
    mx31, over31 = budget(mac, AF._stain_augment_pop_apply(
        AF.stain_augment_fit(batch_cpu, "macenko"), alpha.cpu(),
        beta.cpu()))
    log(31, f"K6 vs functional stain_augment_fit + pop on the CPU: "
            f"max={mx31} u8, share>1={over31:.3e} (gate: <=1 on >99%, "
            f"max<=4)")

    # The Vahadane path, counted: stain_augment on B tiles (K8, then K7).
    vf.dict_launches = mf.augment_launches = mf.aug_launches = 0
    vah = AF.stain_augment(batch, gen(31), "vahadane")
    torch.cuda.synchronize()
    v_launches = (vf.dict_launches, mf.augment_launches, mf.aug_launches)

    # 32. K8 and K7 against their plain versions; the functional budget.
    assert v_launches == (1, 1, 0), v_launches
    a2, b2 = draws(31, (B,))
    m8 = vf.vahadane_stain_matrix_planar(planar)
    m8_plain = vf.vahadane_stain_matrix_planar_ref(planar)
    e8 = float((m8 - m8_plain).abs().nan_to_num(0.0).max())
    assert e8 <= 1e-5, e8
    mx32, share32, _ = compare(vah, fs.from_planar(
        vf.vahadane_augment_planar_ref(planar, a2, b2), SIDE, SIDE))
    m7 = vf._prior_where_nan(m8_plain)
    k7 = mf.augment_with_matrix_planar(planar, m7, a2, b2)
    mx32b, share32b, _ = compare(k7, mf.augment_with_matrix_planar_ref(
        planar, m7, a2, b2))
    assert max(mx32, mx32b) <= 1 and max(share32, share32b) < 1e-3, (
        mx32, share32, mx32b, share32b)
    mx32c, over32c = budget(vah, AF._stain_augment_pop_apply(
        AF.stain_augment_fit(batch_cpu, "vahadane"), a2.cpu(), b2.cpu()))
    assert torch.equal(AF.stain_augment(batch, gen(31), "vahadane"), vah)
    log(32, f"stain_augment('vahadane') B={B} {SIDE}^2: main-path launches "
            f"K8={v_launches[0]} K7={v_launches[1]} K6={v_launches[2]}; K8 "
            f"vs plain max |M| diff {e8:.3e} (atol 1e-5); K8+K7 vs plain "
            f"max={mx32} u8, share differing={share32:.3e}; K7 alone vs "
            f"plain max={mx32b} u8, share differing={share32b:.3e}; vs "
            f"functional on the CPU max={mx32c} u8, share>1={over32c:.3e}; "
            f"rerun identical")

    # The drop-in path, counted: StainAugmentor fit on one image, 8 pops.
    img = batch_np[0]
    aug = st.StainAugmentor("macenko", seed=SEED, device=dev)
    aug.fit(img)
    assert aug._fused_state is not None, "fit did not cache the fused state"
    mf.augment_launches = mf.aug_launches = 0
    pops = [aug.pop() for _ in range(8)]
    torch.cuda.synchronize()
    pop_launches = (mf.augment_launches, mf.aug_launches)

    # 33. One K7 launch per pop, fresh draws, the functional pop's budget.
    assert pop_launches == (8, 0), pop_launches
    assert all((a != b).any() for a, b in zip(pops, pops[1:]))
    ref_gen = torch.Generator().manual_seed(SEED)
    cpu_params = AF.stain_augment_fit(torch.from_numpy(img), "macenko")
    q99 = []
    for got in pops:
        a, b = AF._stain_draws(ref_gen, (1,), 0.2, 0.2, "cpu")
        want = AF._stain_augment_pop_apply(cpu_params, a[0], b[0]).numpy()
        q99.append(float(np.quantile(np.abs(got.astype(int)
                                            - want.astype(int)), 0.99)))
    assert max(q99) <= 4, q99
    log(33, f"StainAugmentor('macenko') {SIDE}^2 fit + 8 pops: main-path "
            f"launches K7={pop_launches[0]} K6={pop_launches[1]}; "
            f"consecutive pops differ; 99th-pct |pop - functional pop| "
            f"max={max(q99)} u8 (gate <=4, tests/test_augmentation.py:201)")

    names = device_events(aug.pop)
    stray = [n for n in names
             if re.search(r"cat|fill|full|zero", n, re.IGNORECASE)]
    assert not stray, f"a pop builds a table on the device: {names}"
    assert not names or any("augment_apply_kernel" in n for n in names), names

    def enter_context():
        with torch.cuda.device(dev):
            pass

    context_us = time_host_us(enter_context)
    # Where a pop's host time goes: the draws and their copy to the card,
    # K7 through its wrapper, the copy-out to numpy.
    g33 = gen(34)
    a33, b33 = AF._stain_draws(g33, (1,), 0.2, 0.2, dev)
    state = aug._fused_state

    def apply_and_wait():
        AF._stain_augment_pop_fused_apply(state, a33, b33)
        torch.cuda.synchronize()

    out33 = AF._stain_augment_pop_fused_apply(state, a33, b33)[0]
    parts = (time_host_us(lambda: AF._stain_draws(g33, (1,), 0.2, 0.2, dev),
                          300),
             time_host_us(apply_and_wait, 300),
             time_host_us(lambda: out33.cpu().numpy(), 300))
    log(33, f"a pop's parts on the host clock, mean of 300: the draws and "
            f"their copy in {parts[0]:.1f} us, K7 through its wrapper and a "
            f"synchronize {parts[1]:.1f} us, the copy-out to numpy "
            f"{parts[2]:.1f} us")
    log(33, f"StainAugmentor.pop one {SIDE}^2 image on the host clock, copy-"
            f"out and synchronize included: {pop_ms(aug):.4f} ms (median of "
            f"64 pops after 8); device activities of 3 pops "
            f"(torch.profiler): {names or 'not measured'}; entering a "
            f"torch.cuda.device context, which a launch on the current "
            f"device now skips: {context_us:.2f} us; card '{smi}'")

    # The large-field path, counted: stain_augment on one 2048^2 field.
    side = FIELDS[-1]
    field = torch.from_numpy(tiles(1, side, SEED + 40)[0]).to(dev)
    mf.augment_launches = mf.aug_launches = 0
    fout = AF.stain_augment(field, gen(32), "macenko")
    torch.cuda.synchronize()
    f_launches = (mf.augment_launches, mf.aug_launches)

    # 34. K7 on the whole field against its plain version and the blocks.
    assert f_launches == (1, 0), f_launches
    fa, fb = (x.reshape(1, 2) for x in draws(32, ()))
    mfield = vf._prior_where_nan(stain_matrix_macenko(field[None]))
    mx34, share34, _ = compare(fout, mf.augment_with_matrix_ref(
        field[None], mfield, fa, fb)[0])
    assert mx34 <= 1 and share34 < 1e-3, (mx34, share34)
    blocks = AF._augment_field(field[None], fa, fb, "macenko", block=512)
    assert torch.equal(blocks[0], fout), "blockified K7 route differs"
    log(34, f"stain_augment('macenko') one {side}^2 field: main-path "
            f"launches K7={f_launches[0]} K6={f_launches[1]}; K7 vs plain "
            f"max={mx34} u8, share differing={share34:.3e}; identical to the "
            f"512^2-blockified route")

    # K7 on an interleaved batch whose H*W is odd: image bases off the
    # 16-byte grid, a scalar head and tail around the 128-bit groups.
    odd = torch.from_numpy(tiles(3, 255, SEED + 41)).to(dev)
    mo = vf._prior_where_nan(stain_matrix_macenko(odd))
    ao, bo = draws(33, (3,))
    for bg in (False, True):
        got = mf.augment_with_matrix(odd, mo, ao, bo, augment_background=bg)
        assert torch.equal(got, mf.augment_with_matrix_ref(
            odd, mo, ao, bo, augment_background=bg)), bg
    log(34, "K7 on 3 interleaved images of 255x255 (H*W odd, bases not "
            "16-byte aligned), background flag off and on: byte-identical "
            "to the plain version")

    # 35. The torch-only augmenters on the card against their CPU
    # evaluation with the same draws; time per batch.
    geo = dict(rotation_range=30.0, width_shift_range=0.1,
               height_shift_range=0.1, shear_range=10.0, zoom_range=0.2,
               channel_shift_range=5.0, horizontal_flip=True,
               vertical_flip=True)
    cases = [("hed_jitter light", AF.hed_light),
             ("hed_jitter strong", AF.hed_strong),
             ("grayscale_augment", AF.grayscale_augment),
             ("rgb_jitter", AF.rgb_jitter), ("hsv_jitter", AH.hsv_jitter),
             ("random_geometric",
              lambda x, g: AG.random_geometric(x, g, **geo))]
    for k, (label, fn) in enumerate(cases):
        card = fn(batch, gen(50 + k)).cpu()
        cpu = fn(batch_cpu, gen(50 + k))
        if card.dtype != torch.uint8:  # the warp returns floats
            card, cpu = (torch.clamp(x, 0, 255).to(torch.uint8)
                         for x in (card, cpu))
        mx35, share35, over35 = compare(card, cpu)
        assert over35 < 1e-2, (label, mx35, over35)
        ms = time_ms(lambda: fn(batch, gen(50 + k)))
        log(35, f"{label} B={B} {SIDE}^2 on the card vs on the CPU: "
                f"max={mx35} u8, share differing={share35:.3e}, share>1="
                f"{over35:.3e} (gate: <=1 on >99%); {ms:.3f} ms per batch "
                f"(median of {REPS} CUDA-event runs); card '{smi}'")

    # 36. Timing at the main paths' shapes, kernel and plain in turns.
    t6 = time_pair(lambda: mf.macenko_augment(batch, alpha, beta),
                   lambda: mf.macenko_augment_ref(batch, alpha, beta))
    t7 = time_pair(
        lambda: mf.augment_with_matrix_planar(planar, m7, a2, b2),
        lambda: mf.augment_with_matrix_planar_ref(planar, m7, a2, b2))
    t7f = time_pair(
        lambda: mf.augment_with_matrix(field[None], mfield, fa, fb),
        lambda: mf.augment_with_matrix_ref(field[None], mfield, fa, fb))
    tv = time_pair(lambda: vf.vahadane_augment(batch, a2, b2),
                   lambda: vf.vahadane_augment_planar_ref(planar, a2, b2))
    for label, ((ka, kb), (pa, pb)) in (
            (f"K6 B={B} {SIDE}^2", t6), (f"K7 B={B} {SIDE}^2", t7),
            (f"K7 one {side}^2 field", t7f),
            (f"vahadane_augment (K8 + K7) B={B} {SIDE}^2", tv)):
        log(36, f"{label}, median of {REPS} CUDA-event runs (plain, kernel, "
                f"kernel, plain): kernel {ka:.3f}/{kb:.3f} ms; plain "
                f"{pa:.3f}/{pb:.3f} ms; card '{smi}'")
    for label, x, a6, b6 in k6_shapes:
        def k6_call(x=x, a6=a6, b6=b6):
            return mf.macenko_augment(x, a6, b6)
        log(36, f"K6 {label}: the kernel alone (torch.profiler device time "
                f"per call, {REPS} calls) "
                f"{fmt_ms(device_ms(k6_call, 'macenko_augment_kernel'))}; by "
                f"events {time_ms(k6_call):.4f} ms (median of {REPS}); card "
                f"'{smi}'")
    for label, fn, name in (
            (f"K7 B={B} {SIDE}^2",
             lambda: mf.augment_with_matrix_planar(planar, m7, a2, b2),
             "augment_apply_kernel"),
            (f"K7 one {side}^2 field",
             lambda: mf.augment_with_matrix(field[None], mfield, fa, fb),
             "augment_apply_kernel")):
        log(36, f"{label}, the kernel alone (torch.profiler device time per "
                f"call, {REPS} calls): {fmt_ms(device_ms(fn, name))}")
    k7_launches = v_launches[1] + pop_launches[0] + f_launches[0]
    return [
        dict(name="macenko_augment_planar", route="cuda",
             source="stainlib_tpu_torch/kernels/csrc/macenko_fused.cu",
             replaces="stainlib_tpu/kernels/macenko_fused.py:822",
             launches=k6_launches, max_abs_err=mx30, ms=min(t6[0]),
             plain_ms=min(t6[1])),
        dict(name="augment_with_matrix_planar", route="cuda",
             source="stainlib_tpu_torch/kernels/csrc/macenko_fused.cu",
             replaces="stainlib_tpu/kernels/macenko_fused.py:886",
             launches=k7_launches, max_abs_err=max(mx32b, mx34),
             ms=min(t7[0]), plain_ms=min(t7[1])),
    ]


def plan_text(kernel: str, side_or_n: int, fit_stride: int | None = None,
              batch: int = 1):
    """The cluster plan of K1, K2 or K8 (a ``side``^2 tile at
    ``fit_stride``), or of K4, K6, K8 or K9 (an ``n``-pixel sample); K1,
    K6, K8 and K9 in a batch of ``batch``; as a phrase."""
    from stainlib_tpu_torch.kernels import macenko_fused as mf

    if fit_stride is None:
        n, shape = side_or_n, f"{side_or_n} px"
    else:
        nblk, blk, _ = mf._sample_args(side_or_n * side_or_n, fit_stride)
        n, shape = nblk * blk, f"{side_or_n}^2 fs={fit_stride}"
    if kernel in ("K1", "K6", "K8", "K9"):
        shape = f"B={batch} {shape}"
    p = mf.cluster_plan(n, kernel, batch=batch, sms=mf.sm_count(0))
    where = (f"{p.smem} B of dynamic shared memory per block" if p.smem
             else "staged in device memory")
    return (f"{kernel} plan at {shape} ({n} sample px): G={p.g} blocks of "
            f"512 threads per tile, {p.slice} px staged per block, {where}")


def k5_plan_text(x) -> str:
    """K5's cluster plan for the interleaved CUDA tiles ``x``, as a phrase."""
    from stainlib_tpu_torch.kernels import reinhard_fused as rf

    slots = rf._block_slots(x.device)
    p = rf.reinhard_plan(x.shape[0], x.shape[1] * x.shape[2], slots)
    return (f"K5 plan for {x.shape[0]} tiles of {x.shape[1] * x.shape[2]} px "
            f"on {slots} block slots: G={p.g} blocks of 512 threads per "
            f"tile, {p.slice} px per block")


# ---- The flow's residual-branch kernels F1 (phase 38) ------------------------
# reference_capacity()'s scales (channels, side), its hidden width and blocks
# per scale; the deploy batch of the benchmark's flow cell.
F1_SCALES = ((1, 256), (4, 128), (16, 64))
F1_HIDDEN, F1_BLOCKS, F1_BATCH = 128, 5, 64


def flow_branch_phase(smi) -> dict:
    """Phase 38: F1 (``kernels/flow_branch.py``) at each scale of
    ``reference_capacity()`` on ``F1_BATCH`` tiles, autograd off, TF32 off:
    against its plain version (largest gap over the largest value within
    1e-5: the same float32 products summed in another order), a second run
    byte for byte, and timed in turns with the plain version, then
    ``x + lipschitz_apply`` (the model's cuDNN route), beside the branch's
    least time, its convolutions' operations over 67 TFLOP/s. Returns F1's
    ``kernels`` entry for one deploy encode (``F1_BLOCKS`` branches a
    scale); :func:`run` fills in its launches."""
    from stainlib_tpu_torch.kernels import flow_branch as fb
    from stainlib_tpu_torch.models.flow_layers import lipschitz_apply

    assert not (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)
    hid, scales = F1_HIDDEN, []
    for c, side in F1_SCALES:
        g = torch.Generator().manual_seed(SEED + c)
        weights = []
        for (o, i), k in zip([(hid, c), (hid, hid), (c, hid)], (3, 1, 3)):
            w = torch.randn((o, i, k, k), generator=g) / (i * k * k) ** 0.5
            b = torch.randn((o,), generator=g) * 0.1
            weights.append((w.cuda(), b.cuda()))
        x = torch.randn((F1_BATCH, c, side, side), generator=g).cuda()
        with torch.inference_mode():
            before = fb.launches
            got = fb.flow_branch(x, weights)
            assert fb.launches == before + 1
            want = fb.flow_branch_plain(x, weights)
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            assert rel <= 1e-5, (c, side, rel)
            assert torch.equal(fb.flow_branch(x, weights), got), (c, side)
            del got, want
            (ka, kb), (pa, pb) = time_pair(
                lambda: fb.flow_branch(x, weights),
                lambda: fb.flow_branch_plain(x, weights))
            lib = time_ms(lambda: x + lipschitz_apply(x, weights))
        ops = 2 * F1_BATCH * side * side * (9 * c * hid + hid * hid
                                            + hid * 9 * c)
        row = dict(c=c, side=side, max_abs_err=err, max_rel_err=rel,
                   ms=min(ka, kb), plain_ms=min(pa, pb), library_ms=lib,
                   bound_ms=ops / F32_OPS_PER_S * 1e3)
        scales.append(row)
        log(38, f"F1 flow_branch B={F1_BATCH} c={c} {side}^2, hidden {hid}, "
                f"3-1-3: max |kernel - plain| {err:.3e} = {rel:.3e} of the "
                f"largest value (gate 1e-5), rerun identical; median of "
                f"{REPS} CUDA-event runs (plain, kernel, kernel, plain): "
                f"kernel {ka:.3f}/{kb:.3f} ms, plain {pa:.3f}/{pb:.3f} ms, "
                f"x + lipschitz_apply {lib:.3f} ms; bound "
                f"{row['bound_ms']:.3f} ms ({ops / 1e9:.1f} GFLOP at 67 "
                f"TFLOP/s), {row['bound_ms'] / row['ms']:.1%} of it; card "
                f"'{smi}'")
        del x, weights
        torch.cuda.empty_cache()

    def encode(key):
        return F1_BLOCKS * sum(r[key] for r in scales)

    return dict(name="flow_branch", route="cuda",
                source="stainlib_tpu_torch/kernels/csrc/flow_branch.cu",
                replaces=None, launches=None,
                max_abs_err=max(r["max_abs_err"] for r in scales),
                max_rel_err=max(r["max_rel_err"] for r in scales),
                ms=encode("ms"), plain_ms=encode("plain_ms"),
                bound_ms=encode("bound_ms"), bound_by="operations",
                library_ms=encode("library_ms"), scales=scales)


def parent_phases() -> None:
    """Phases 39-40, where ``.runs/parent`` holds a ``git archive`` of the
    parent commit: ``scripts/torch_time_trees.py`` times both trees' public
    entry points (the kernels' entries, the functional paths, the
    augmenters) in turns,
    and ``scripts/torch_compare_trees.py`` compares all ten kernels'
    outputs."""
    root = Path(__file__).resolve().parent
    parent = root / ".runs" / "parent"
    if not (parent / "stainlib_tpu_torch").is_dir():
        log(39, f"no parent tree at .runs/{parent.name}: the trees are "
                f"neither timed nor compared")
        return

    def script(name):
        out = subprocess.run(
            [sys.executable, str(root / "scripts" / name), str(parent)],
            capture_output=True, text=True, timeout=600, check=True)
        return out.stdout.strip().splitlines()

    # 39. Both trees' entry points in turns (parent, this, this, parent).
    lines = script("torch_time_trees.py")
    for ln in lines[:-2]:
        log(39, f"{ln.replace('other', 'parent')} (median of {REPS} "
                f"CUDA-event runs per process; card '{lines[-2]}')")

    # 40. Every kernel's output in both trees, on the same inputs.
    summary = json.loads(script("torch_compare_trees.py")[-1])
    for name, k in summary["kernels"].items():
        log(40, f"{name}: {k['differ_between_trees']} of {k['values']} "
                f"values differ from the parent's (max {k['max_abs_diff']}); "
                f"vs plain: this tree {k['this_vs_plain_differ']}, parent "
                f"{k['other_vs_plain_differ']}")
        if name.startswith("K10"):  # float32 planes: the 1e-6 budget
            assert k["this_vs_plain_max"] <= 1e-6, name
            assert k["max_abs_diff"] <= 1e-6, name
        else:
            assert k["this_vs_plain_differ"] == 0, name
            assert k["differ_between_trees"] == 0, name


# ---- Whole-slide deployment (phases 41-47) ----------------------------------

SLIDE_SIDE = 16384  # 805 MB of level 0, 4,096 tiles of 256^2
SLIDE_SMALL = (2000, 2300)  # width, height: partial tiles on both edges
SLIDE_MID = 4096  # 256 tiles: the four routes end to end
SLIDE_BATCH = 64
STREAM_BATCHES = 96  # phase 46: the training-tile stream, BASELINE #5
# Functional-path budgets of the four routes (PERF.md section 2): max u8,
# and the bound on the share of bytes off by more than 1 or, where the
# budget counts bytes within 1 (K3, K5), the share allowed beyond 1. K5's
# max is 4, not tests/test_reinhard_fused.py:23-24's 3: on this slide's
# tiles the JAX package's own K5 and functional Reinhard differ by 4 u8 on
# a few bytes per tile, and the port equals both
# (tests/test_torch_reinhard.py::test_k5_functional_gap_is_the_references).
SLIDE_ROUTES = {
    # route: (method, estimation, kernel, max, share > 1 below)
    "K3": ("macenko", "slide", "normalize_with_matrix_planar", 3, 5e-3),
    "K1": ("macenko", "tile", "macenko_normalize_planar", 2, 1e-2),
    "K2": ("vahadane", "tile", "vahadane_normalize_planar", 4, 1e-2),
    "K5": ("reinhard", "tile", "reinhard_normalize_planar", 4, 1e-2),
}


def synth_level0(w: int, h: int, tile: int, seed: int) -> np.ndarray:
    """An H&E-like w x h field, ``scripts/bench_wsi_scale.py::synth_level0``'s
    recipe (smooth sinusoidal concentration fields, noise from ``seed``,
    white margins at the top and left), made row band by row band, with a
    white band one tile high across the middle (whole background tiles)."""
    he = np.array([[0.55, 0.72, 0.42], [0.17, 0.80, 0.57]])
    he = (he / np.linalg.norm(he, axis=1, keepdims=True)).astype(np.float32)
    rng = np.random.default_rng(seed)
    lv0 = np.empty((h, w, 3), np.uint8)
    xs = np.arange(w, dtype=np.float32)
    for r0 in range(0, h, tile):
        r1 = min(r0 + tile, h)
        yy = np.arange(r0, r1, dtype=np.float32)[:, None]
        c_h = np.clip(0.8 + 0.6 * np.sin(yy / 9.0) * np.cos(xs / 7.0), 0, None)
        c_e = np.clip(0.6 + 0.4 * np.cos(yy / 11.0) * np.sin(xs / 5.0), 0,
                      None)
        C = np.stack([c_h, c_e], -1).astype(np.float32)
        C *= 0.9 + 0.2 * rng.random((r1 - r0, w, 2), np.float32)
        img = 255.0 * np.exp(-(C.reshape(-1, 2) @ he))
        lv0[r0:r1] = np.clip(img, 0, 255).astype(np.uint8).reshape(
            r1 - r0, w, 3)
    m = tile // 2
    lv0[:m] = 255
    lv0[:, :m] = 255
    lv0[h // 2: h // 2 + tile] = 255
    return lv0


def trace_activities(prof) -> dict:
    """{device activity name: (count, total ms)} of a ``torch.profiler``
    trace."""
    return {e.key: (e.count, getattr(e, "device_time_total", 0.0) / 1e3)
            for e in prof.key_averages()
            if getattr(e, "device_time_total", 0.0) > 0}


def slide_phases(dev, smi, then=None) -> dict:
    """Phases 41-47: whole-slide deployment through
    ``normalization.slide.normalize_slide``, the user's entry point (the
    reference's ``tester`` loop): a 16,384^2 slide in slide mode (K3), then
    the four kernel routes (K3, K1, K2, K5) at 2000x2300 against their
    plain versions and the functional path, and end to end at 4096^2;
    then :func:`mesh_phases` on these slides, and ``then(dev, smi, work,
    big)`` while the work directory and the 16,384^2 slide (with its
    polygon, ``slide16k.xml``) still exist. Returns each route's
    launches on its main run (phase 42 for K3, phase 44 for K1, K2 and K5)
    and, under ``<route>_<path>``, on the paths of phases 45-47 and on
    those that ``then`` returns (phases 66-67)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from stainlib_tpu_torch.data import native
    from stainlib_tpu_torch.kernels import macenko_fused as mf
    from stainlib_tpu_torch.kernels import reinhard_fused as rf
    from stainlib_tpu_torch.kernels import vahadane_fused as vf
    from stainlib_tpu_torch.normalization import extractive, reinhard
    from stainlib_tpu_torch.normalization import slide as sl

    def counts():
        return dict(K3=mf.matrix_launches, K1=mf.launches, K2=vf.launches,
                    K5=rf.launches)

    def reset():
        mf.matrix_launches = mf.launches = vf.launches = rf.launches = 0

    tiff = native.tiff_native_available()
    parts = ("fit_slide", "fit_slide_reinhard", "_stream_canvas",
             "build_pyramid", "write_tiff_pyramid")

    def drive(src, out, target, traced=False, **kw):
        """``normalize_slide(src, out, target, **kw)`` on the card, each
        part timed on the host clock (a synchronize after each), the
        stream traced by ``torch.profiler`` where ``traced``. Returns (the
        summary, the level-0 canvas the stream filled, the times in s, the
        stream's trace or None). Where the host has libtiff, the written
        level 0 is read back and must equal the canvas (JPEG: a mean error
        under 3); where it has none, the writer is not run."""
        times, seen = {}, {}
        real = {n: getattr(sl, n) for n in parts}

        def timed(name):
            def run(*a, **k):
                torch.cuda.synchronize()
                if name == "write_tiff_pyramid" and not tiff:
                    times[name] = None
                    return None
                if name == "_stream_canvas" and traced:
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        t0 = time.perf_counter()
                        res = real[name](*a, **k)
                        torch.cuda.synchronize()
                        times[name] = time.perf_counter() - t0
                    seen["prof"] = prof
                else:
                    t0 = time.perf_counter()
                    res = real[name](*a, **k)
                    torch.cuda.synchronize()
                    times[name] = time.perf_counter() - t0
                if name == "_stream_canvas":
                    seen["canvas"] = res[0]
                return res
            return run

        for n in parts:
            setattr(sl, n, timed(n))
        try:
            t0 = time.perf_counter()
            info = sl.normalize_slide(src, out, target, device=dev, **kw)
            torch.cuda.synchronize()
            times["total"] = time.perf_counter() - t0
        finally:
            for n, f in real.items():
                setattr(sl, n, f)
        if tiff:  # what was written is the canvas (JPEG: lossy)
            s = native.TiffSlide(out)
            written = s.read_region(0, 0, 0, *s.level_size(0))
            s.close()
            d = np.abs(written.astype(np.int16) - seen["canvas"])
            assert (d.max() == 0 if kw.get("compression") == "none"
                    else d.mean() < 3.0), "the written level 0 differs"
        return info, seen["canvas"], times, seen.get("prof")

    def grid_tiles(path, tile=256):
        s = native.open_slide(path)
        W, H = s.level_size(0)
        coords = sl._grid_coords(W, H, tile)
        tl = np.stack([s.read_region(0, x, y, tile, tile) for x, y in coords])
        s.close()
        return coords, tl, W, H

    def assemble(coords, tl, W, H, tile=256):
        canvas = np.empty((H, W, 3), np.uint8)
        for (x, y), t in zip(coords, tl):
            h, w = min(tile, H - y), min(tile, W - x)
            canvas[y:y + h, x:x + w] = t[:h, :w]
        return canvas

    def fmt_times(t):
        return ", ".join(
            f"{k} {'not run (no libtiff)' if v is None else f'{v:.3f} s'}"
            for k, v in t.items())

    root = Path(__file__).resolve().parent
    (root / ".runs").mkdir(exist_ok=True)
    # A target whose stain geometry differs from the slide's, so the
    # normalization visibly moves the tissue (scripts/normalize_wsi.py's).
    stain = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]])
    target = synth_module().he_patch(
        SIDE, SIDE, seed=SEED + 40, background_frac=0.0,
        stain=stain / np.linalg.norm(stain, axis=1, keepdims=True))
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_slide_",
                                     dir=root / ".runs") as work:
        work = Path(work)
        if not tiff:
            log(41, "the TIFF writer is not run in phases 42-44: this host "
                    "has no libtiff (no tiffio.h to build tiffreader.cpp "
                    "against), so write_tiff_pyramid would raise; the phases "
                    "read level 0 from the canvas _stream_canvas returns, "
                    "and the writer is held by the CPU tests alone")

        # 41. The slide: 16,384^2 WSIRAW, row band by row band, from a seed.
        t0 = time.perf_counter()
        lv0 = synth_level0(SLIDE_SIDE, SLIDE_SIDE, SIDE, SEED + 41)
        t_synth = time.perf_counter() - t0
        big = str(work / "slide16k.wsiraw")
        t0 = time.perf_counter()
        # Level 1, a 1/16 subsample, is where the WSI sampler (phase 46)
        # finds the tissue; normalize_slide reads level 0 only.
        native.write_wsiraw(big, [lv0, lv0[::16, ::16].copy()])
        t_write = time.perf_counter() - t0
        s = native.open_slide(big)
        is_native = s.native
        assert isinstance(s, native.RawSlide) and is_native, (
            "the native WSIRAW reader did not load")
        assert s.level_size(0) == (SLIDE_SIDE, SLIDE_SIDE)
        assert s.level_size(1) == (SLIDE_SIDE // 16, SLIDE_SIDE // 16)
        s.close()
        n_big = (SLIDE_SIDE // SIDE) ** 2
        log(41, f"slide {SLIDE_SIDE}x{SLIDE_SIDE} ({lv0.nbytes / 1e6:.0f} MB "
                f"of level 0, {n_big} tiles of {SIDE}^2): made in "
                f"{t_synth:.2f} s, written as WSIRAW in {t_write:.2f} s; "
                f"open_slide -> RawSlide, native={is_native}")

        # 42. Slide mode, Macenko, JPEG output, batch 64: the main run (A)
        # timed by parts, then a second run (B) with the stream traced.
        reset()
        info, out_a, t_a, _ = drive(big, str(work / "out_a.tif"), target,
                                    method="macenko", estimation="slide",
                                    batch=SLIDE_BATCH)
        torch.cuda.synchronize()
        launches["K3"] = counts()["K3"]
        n_batches = -(-n_big // SLIDE_BATCH)
        assert info["fused"] is True and info["tiles"] == n_big, info
        assert counts() == dict(K3=n_batches, K1=0, K2=0, K5=0), counts()
        assert out_a.shape == lv0.shape and out_a.dtype == np.uint8
        assert out_a[:64].min() >= 250, "the white margin did not stay white"
        q = SLIDE_SIDE // 4  # a tissue quarter, clear of the white bands
        assert np.abs(out_a[q:2 * q, q:2 * q].astype(np.int16)
                      - lv0[q:2 * q, q:2 * q]).mean() > 2.0
        e2e = n_big / t_a["total"]
        log(42, f"normalize_slide {SLIDE_SIDE}^2 macenko slide-mode batch "
                f"{SLIDE_BATCH} jpeg: {info}; K3 launches {launches['K3']} "
                f"(= ceil({n_big}/{SLIDE_BATCH})); host clock: "
                f"{fmt_times(t_a)}; end to end {e2e:.1f} tiles/s; card "
                f"'{smi}'")
        reset()
        _, out_b, t_b, prof = drive(big, str(work / "out_b.tif"), target,
                                    traced=True, method="macenko",
                                    estimation="slide", batch=SLIDE_BATCH)
        assert counts()["K3"] == n_batches
        assert np.array_equal(out_a, out_b), "two runs differ"
        acts = trace_activities(prof)
        stream_ms = t_b["_stream_canvas"] * 1e3
        k3 = [v for k, v in acts.items() if "matrix_apply_kernel" in k]
        k3_ms = sum(ms for _, ms in k3)
        busy_ms = sum(ms for _, ms in acts.values())
        other = [k for k in acts if "matrix_apply_kernel" not in k
                 and not k.startswith(("Memcpy HtoD", "Memcpy DtoH"))]
        assert not other, f"the stream ran other device work: {other}"
        assert sum(c for c, _ in k3) <= n_batches
        share = (f"K3 {k3_ms:.4f} ms = {k3_ms / stream_ms:.3%} of the "
                 f"stream's wall time, all device activity {busy_ms:.3f} ms "
                 f"= {busy_ms / stream_ms:.2%}: the device idles "
                 f"{1 - busy_ms / stream_ms:.2%} of the stream" if acts
                 else "the profiler recorded no device activity: K3's "
                      "device time and share not measured")
        log(42, f"run B, stream traced: {t_b['_stream_canvas']:.3f} s on the "
                f"host clock (run A {t_a['_stream_canvas']:.3f} s); device "
                f"activities {{name: (count, ms)}} "
                f"{ {k: (c, round(ms, 4)) for k, (c, ms) in acts.items()} }; "
                f"{share}; run B's level 0 equals run A's; card '{smi}'")
        # The stream's host parts alone: the decode of its 64 batches (the
        # per-region reads and the stack, one thread) and the placement of
        # run A's bytes into a canvas.
        coords = sl._grid_coords(SLIDE_SIDE, SLIDE_SIDE, SIDE)
        s = native.open_slide(big)
        t0 = time.perf_counter()
        for i in range(0, n_big, SLIDE_BATCH):
            np.stack([s.read_region(0, x, y, SIDE, SIDE)
                      for x, y in coords[i:i + SLIDE_BATCH]])
        t_decode = time.perf_counter() - t0
        s.close()
        canvas = np.empty_like(out_a)
        t0 = time.perf_counter()
        for x, y in coords:
            canvas[y:y + SIDE, x:x + SIDE] = out_a[y:y + SIDE, x:x + SIDE]
        t_place = time.perf_counter() - t0
        del canvas
        log(42, f"the stream's host parts alone, one thread: decode "
                f"{t_decode:.3f} s ({t_decode / n_batches * 1e3:.1f} ms per "
                f"batch of {SLIDE_BATCH}), placement {t_place:.3f} s; the "
                f"stream {t_a['_stream_canvas']:.3f} s with "
                f"prefetch_workers=2")

        # Grid tiles of run A against the plain version on the same tiles:
        # 64 of the 4,096, drawn from a seed.
        src = sl.fit_slide(big, device=dev)
        tp = extractive.fit(torch.from_numpy(target).to(dev))
        pick = np.random.default_rng(SEED).choice(
            len(coords), min(64, len(coords)), replace=False)
        s = native.open_slide(big)
        tl = np.stack([s.read_region(0, *coords[i], SIDE, SIDE)
                       for i in pick])
        s.close()
        want = mf.normalize_with_matrix_ref(
            torch.from_numpy(tl).to(dev), src.stain_matrix, src.max_c,
            *tp).cpu().numpy()
        for i, w in zip(pick, want):
            x, y = coords[i]
            assert np.array_equal(out_a[y:y + SIDE, x:x + SIDE], w), (
                "K3 on the slide differs from its plain version", x, y)
        log(42, f"{len(pick)} grid tiles of run A, drawn from a seed, equal "
                f"byte for byte to normalize_with_matrix_ref on the same "
                f"tiles")
        del lv0, out_a, out_b, tl, coords

        # 43. The four routes at 2000x2300, lossless: the plain version
        # byte for byte, the functional path's budget, determinism.
        w_s, h_s = SLIDE_SMALL
        small = str(work / "small.wsiraw")
        native.write_wsiraw(small, [synth_level0(w_s, h_s, SIDE, SEED + 43)])
        coords, tl, W, H = grid_tiles(small)
        x = torch.from_numpy(tl).to(dev)
        n_small = len(coords)
        for route, (method, est, _, mx_gate, over_gate) in \
                SLIDE_ROUTES.items():
            if method == "reinhard":
                tp = reinhard.fit(torch.from_numpy(target).to(dev))
            else:
                tp = extractive.fit(torch.from_numpy(target).to(dev),
                                    method=method)
            outs = []
            for run in range(2):
                reset()
                info, got, _, _ = drive(small, str(work / f"{route}.tif"),
                                        tp, method=method, estimation=est,
                                        batch=SLIDE_BATCH, compression="none")
                assert info["fused"] is True, (route, info)
                c = counts()
                assert c[route] == -(-n_small // SLIDE_BATCH) and sum(
                    c.values()) == c[route], (route, c)
                outs.append(got)
            assert np.array_equal(outs[0], outs[1]), (route, "runs differ")
            if route == "K3":
                src = sl.fit_slide(small, device=dev)
                args = (src.stain_matrix, src.max_c, *tp)
                plain = mf.normalize_with_matrix_ref(x, *args)
                func = extractive.transform_with_matrix(x, *args[:2], tp)
            elif route == "K1":
                plain = mf.macenko_normalize_ref(x, *tp)
                func = extractive.transform(tp, x)
            elif route == "K2":
                plain = vf.vahadane_normalize_ref(x, *tp)
                func = extractive.transform(tp, x, method="vahadane")
            else:
                plain = rf.reinhard_normalize_ref(x, *tp)
                func = reinhard.transform(
                    reinhard.ReinhardParams(*(t.cpu() for t in tp)), x.cpu())
            plain = assemble(coords, plain.cpu().numpy(), W, H)
            func = assemble(coords, func.cpu().numpy(), W, H)
            assert np.array_equal(outs[0], plain), (
                route, "differs from its plain version")
            d = np.abs(outs[0].astype(np.int16) - func)
            mx, over1 = int(d.max()), float((d > 1).mean())
            assert mx <= mx_gate and over1 < over_gate, (route, mx, over1)
            log(43, f"{route} ({method}, estimation={est}) {w_s}x{h_s}, "
                    f"{n_small} tiles, batch {SLIDE_BATCH}, lossless: equal "
                    f"byte for byte to its plain version; vs the functional "
                    f"path max={mx} u8, share>1={over1:.3e} (gate: max<="
                    f"{mx_gate}, share>1<{over_gate}); two runs identical; "
                    f"launches per run {c[route]}")
        del x, tl

        # 44. The four routes end to end at 4096^2 (256 tiles).
        mid = str(work / "mid.wsiraw")
        native.write_wsiraw(mid, [synth_level0(SLIDE_MID, SLIDE_MID, SIDE,
                                               SEED + 44)])
        n_mid = (SLIDE_MID // SIDE) ** 2
        for route, (method, est, _, _, _) in SLIDE_ROUTES.items():
            drive(mid, str(work / "warm.tif"), target, method=method,
                  estimation=est, batch=SLIDE_BATCH)  # warm-up
            reset()
            info, _, t, _ = drive(mid, str(work / f"mid_{route}.tif"),
                                  target, method=method, estimation=est,
                                  batch=SLIDE_BATCH)
            c = counts()
            assert info["fused"] is True and c[route] == -(-n_mid // SLIDE_BATCH)
            if route != "K3":
                launches[route] = c[route]
            log(44, f"{route} ({method}, estimation={est}) {SLIDE_MID}^2, "
                    f"{n_mid} tiles: {n_mid / t['total']:.1f} tiles/s end "
                    f"to end; {fmt_times(t)}; launches {c[route]}; card "
                    f"'{smi}'")

        # 45-47. The distributed layer, the training-tile stream and the
        # slide over a mesh.
        launches.update(mesh_phases(dev, smi, work, big, mid, target,
                                    drive, grid_tiles, assemble, counts,
                                    reset))
        if then is not None:  # phases that use the slide and its polygon
            launches.update(then(dev, smi, work, big) or {})
    return launches


def mesh_phases(dev, smi, work, big, mid, target, drive, grid_tiles,
                assemble, counts, reset) -> dict:
    """Phases 45-47 on an NCCL world of this process alone
    (``make_mesh()``; NCCL takes one rank per card, so the cross-rank paths
    are held by gloo in the CPU tests): 45, ``normalize_batch_sharded``
    with K1 and K2 on 256 tiles of 256^2, ``sharded_concentrations`` and
    the collectives through NCCL on CUDA tensors; 46, BASELINE config #5's
    streaming feed (``WsiSampler.train_batches`` -> ``DevicePrefetcher`` ->
    K1) off the 16,384^2 slide with one annotated tumor polygon; 47,
    ``normalize_slide(mesh=...)`` at 4096^2 in slide mode (K3) and tile
    mode (K1) against the call without a mesh. Every collective has the
    process group's time limit (``parallel.mesh.TIMEOUT``); the group is
    torn down at the end. Returns each path's launches."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from stainlib_tpu_torch.data.pipeline import DevicePrefetcher
    from stainlib_tpu_torch.data.wsi import SamplerConfig, WsiSampler
    from stainlib_tpu_torch.kernels import macenko_fused as mf
    from stainlib_tpu_torch.kernels import vahadane_fused as vf
    from stainlib_tpu_torch.kernels.fused_stain import from_planar, to_planar
    from stainlib_tpu_torch.normalization import extractive
    from stainlib_tpu_torch.normalization import slide as sl
    from stainlib_tpu_torch.ops.lasso import nonneg_lasso_k2
    from stainlib_tpu_torch.parallel import collectives as pc
    from stainlib_tpu_torch.parallel.mesh import TIMEOUT, make_mesh
    from stainlib_tpu_torch.parallel.stain_sharded import (
        normalize_batch_sharded, sharded_concentrations)

    launches = {}
    mesh = make_mesh(device=dev.type)
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == (
            "nccl" if dev.type == "cuda" else "gloo")
        log(45, f"make_mesh(): {mesh}, backend {dist.get_backend()}, world "
                f"{dist.get_world_size()}, every collective limited to "
                f"{TIMEOUT.total_seconds():.0f} s")

        # 45. Sharded normalize: K1 and K2 at the kernels' defaults on this
        # rank's rows (all 256 at world 1), gathered through NCCL.
        tgt_np = tiles(1, SIDE, SEED)[0]
        batch_np = tiles(B, SIDE, SEED + 45)
        x = torch.from_numpy(batch_np).to(dev)
        for name, method, mod, kern, plain, gate in (
                ("K1", "macenko", mf, mf.macenko_normalize_planar,
                 mf.macenko_normalize_ref, 2),
                ("K2", "vahadane", vf, vf.vahadane_normalize_planar,
                 vf.vahadane_normalize_ref, 4)):
            def sharded(method=method, batch=batch_np):
                return pc.all_gather_metrics(normalize_batch_sharded(
                    mesh, tgt_np, batch, method=method, fused=True), mesh)

            mod.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = sharded()
            torch.cuda.synchronize()
            t_sh = time.perf_counter() - t0
            launches[f"{name}_sharded"] = mod.launches
            assert mod.launches == 1, (name, mod.launches)
            tp = extractive.fit(torch.from_numpy(tgt_np).to(dev),
                                method=method)
            direct = from_planar(kern(to_planar(x).contiguous(), *tp),
                                 SIDE, SIDE)
            assert got.shape == x.shape and got.dtype == torch.uint8
            assert torch.equal(got, direct), (name, "differs from the "
                                              "direct kernel call")
            assert torch.equal(got, sharded(batch=x)), (name,
                                                        "two runs differ")
            assert torch.equal(got, plain(x, *tp)), (
                name, "differs from its plain version")
            mx, share, over = compare(got, extractive.transform(
                tp, x, method=method))
            assert mx <= gate and over < 1e-2, (name, mx, over)
            tgt_t = torch.from_numpy(tgt_np).to(dev)

            def direct_call(kern=kern, method=method):
                """The same work without the mesh: fit, the kernel."""
                p = extractive.fit(tgt_t, method=method)
                return from_planar(kern(to_planar(x).contiguous(), *p),
                                   SIDE, SIDE)

            # Both on the batch already on the card: the same work but the
            # mesh's row slice and all-gather.
            (sa, sb), (da, db) = time_pair(lambda: sharded(batch=x),
                                           direct_call)
            log(45, f"normalize_batch_sharded({method}, fused=True) B={B} "
                    f"{SIDE}^2 on the mesh: {name} launches "
                    f"{launches[f'{name}_sharded']}; equal byte for byte to "
                    f"the direct kernel call, to its plain version and to a "
                    f"second run; vs the functional path max={mx} u8 (gate "
                    f"<={gate}), share differing={share:.3e}, share>1="
                    f"{over:.3e}; first call (host tiles) {t_sh * 1e3:.1f} ms "
                    f"on the host clock; then on the tiles on the card, by "
                    f"CUDA events (median of {REPS}, in turns direct, "
                    f"sharded, sharded, direct; each the target's fit and "
                    f"the kernel) sharded {sa:.3f} / {sb:.3f} ms, direct "
                    f"{da:.3f} / {db:.3f} ms; card '{smi}'")
        del x

        g = torch.Generator(device=dev).manual_seed(SEED)
        od = torch.rand(65536 * 256, 3, device=dev, generator=g)
        M = extractive.fit(torch.from_numpy(tgt_np).to(dev))[0]
        conc = pc.all_gather_metrics(sharded_concentrations(mesh, od, M),
                                     mesh, "data")
        assert torch.equal(conc, nonneg_lasso_k2(od, M))
        del od, conc
        v = torch.randn(1000, 3, device=dev, generator=g)
        tree = {"v": v, "rows": (v[:7], None)}
        assert torch.equal(pc.psum_stats(tree, mesh)["v"], v)
        assert torch.equal(pc.all_gather_metrics(tree, mesh)["rows"][0],
                           v[:7])
        assert torch.equal(pc.broadcast_from_zero(tree, mesh)["v"], v)
        assert torch.equal(pc.pmean_grads(tree, mesh)["v"], v)
        bf = pc.pmean_grads(tree, mesh, compress=True)["v"]
        assert bf.dtype == torch.float32
        assert torch.equal(bf, v.to(torch.bfloat16).float())
        log(45, f"sharded_concentrations on {65536 * 256:,} x 3 OD pixels "
                f"equal to nonneg_lasso_k2; psum_stats, all_gather_metrics, "
                f"broadcast_from_zero and pmean_grads (compress False and "
                f"True: the bfloat16 rounding) through NCCL on CUDA tensors, "
                f"each its expected value")

        # 46. BASELINE config #5 (bench.py:224-290): WsiSampler ->
        # DevicePrefetcher(depth=4, workers=3) -> K1 at its defaults, batches
        # of 64 with half from the tumor polygon.
        xml = work / "slide16k.xml"  # matched to the slide by its name
        xml.write_text(
            "<ASAP_Annotations><Annotations><Annotation Name=\"t\" "
            "Type=\"Polygon\"><Coordinates>" + "".join(
                f'<Coordinate Order="{i}" X="{x}" Y="{y}"/>'
                for i, (x, y) in enumerate(
                    (SLIDE_SIDE // 8 * np.array([[1, 1], [7, 1], [7, 6],
                                                 [1, 6]])).tolist()))
            + "</Coordinates></Annotation></Annotations></ASAP_Annotations>")
        cfg = SamplerConfig(tile=SIDE, batch_size=64, batch_tumor_ratio=0.5)
        t0 = time.perf_counter()
        sampler = WsiSampler([big], [str(xml)], cfg, seed=SEED)
        t_init = time.perf_counter() - t0
        tp = extractive.fit(torch.from_numpy(target).to(dev))

        def stream(traced: bool):
            """One pass of STREAM_BATCHES batches: (tiles/s on the host
            clock after the first batch, the first batch and its output,
            tumor tiles per batch, the trace or None, the stream's s)."""
            feed = DevicePrefetcher(
                sampler.train_batches(num_batches=STREAM_BATCHES), depth=4,
                workers=3, device=dev)
            first, first_flags = next(feed)
            out0 = mf.macenko_normalize(first, *tp)
            torch.cuda.synchronize()
            flags, acc, count = [first_flags], None, 0
            with (profile(activities=[ProfilerActivity.CUDA]) if traced
                  else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                for xb, fb in feed:
                    y = mf.macenko_normalize(xb, *tp)
                    # A dependent fold keeps every output on the critical
                    # path (bench.py's drain), the inputs streaming freely.
                    acc = y if acc is None else torch.maximum(acc, y)
                    flags.append(fb)
                    count += xb.shape[0]
                int(acc.max())
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            return (count / dt, first, out0,
                    [int(f.sum()) for f in flags], prof, dt)

        host = sampler.train_batches(num_batches=16)
        t0 = time.perf_counter()
        for _ in host:
            pass
        t_sample = (time.perf_counter() - t0) / 16
        reset()
        tps, first, out0, n_tumor, _, dt = stream(traced=False)
        launches["K1_stream"] = counts()["K1"]
        assert launches["K1_stream"] == STREAM_BATCHES, counts()
        assert counts() == dict(K1=STREAM_BATCHES, K2=0, K3=0, K5=0)
        assert first.shape == (64, SIDE, SIDE, 3) and first.device == dev
        assert n_tumor == [32] * STREAM_BATCHES, n_tumor
        assert torch.equal(out0, mf.macenko_normalize_ref(first, *tp)), (
            "K1 on the first streamed batch differs from its plain version")
        tps_b, _, _, _, prof, dt_b = stream(traced=True)
        acts = trace_activities(prof)
        k1 = [v for k, v in acts.items() if "macenko_apply_kernel" in k]
        k1_ms = sum(ms for _, ms in k1)
        busy_ms = sum(ms for _, ms in acts.values())
        share = (f"K1 {k1_ms:.3f} ms over {sum(c for c, _ in k1)} launches "
                 f"= {k1_ms / (dt_b * 1e3):.2%} of the traced stream's "
                 f"{dt_b:.3f} s; all device activity {busy_ms:.3f} ms: the "
                 f"device idles {1 - busy_ms / (dt_b * 1e3):.2%} of it"
                 if acts else "the profiler recorded no device activity: "
                              "K1's device time and the idle share not "
                              "measured")
        log(46, f"streaming feed (BASELINE #5) off the {SLIDE_SIDE}^2 "
                f"slide: WsiSampler(tile={SIDE}, batch_size=64, "
                f"batch_tumor_ratio=0.5; built in {t_init:.2f} s; one "
                f"batch alone on one thread {t_sample * 1e3:.1f} ms, "
                f"{64 / t_sample:.0f} tiles/s) -> "
                f"DevicePrefetcher(depth=4, workers=3) -> K1 at its "
                f"defaults; {STREAM_BATCHES} batches, K1 launches "
                f"{launches['K1_stream']}; tumor tiles per batch {n_tumor}; "
                f"run A {tps:.1f} tiles/s on the host clock over the "
                f"{STREAM_BATCHES - 1} batches after the first ({dt:.3f} s); "
                f"run B, traced, {tps_b:.1f} tiles/s; {share}; device "
                f"activities {{name: (count, ms)}} "
                f"{ {k: (c, round(ms, 3)) for k, (c, ms) in acts.items()} }; "
                f"the first batch equals K1's plain version; card '{smi}'")

        # 47. normalize_slide over the mesh at 4096^2: slide mode (K3) and
        # tile mode (K1) against the same call without a mesh, and the
        # plain versions on the same tiles.
        coords, tl, W, H = grid_tiles(mid)
        xt = torch.from_numpy(tl).to(dev)
        n_mid = len(coords)
        for route, method, est in (("K3", "macenko", "slide"),
                                   ("K1", "macenko", "tile")):
            reset()
            info_m, got, _, _ = drive(mid, str(work / f"mesh_{route}.tif"),
                                      target, method=method,
                                      estimation=est, batch=SLIDE_BATCH,
                                      mesh=mesh)
            launches[f"{route}_mesh_slide"] = counts()[route]
            assert info_m["fused"] is True and counts()[route] == -(
                -n_mid // SLIDE_BATCH) and sum(counts().values()) == counts()[
                route], (route, counts())
            _, want, _, _ = drive(mid, str(work / f"one_{route}.tif"),
                                  target, method=method, estimation=est,
                                  batch=SLIDE_BATCH)
            assert np.array_equal(got, want), (route, "the mesh run differs")
            # End to end in turns: without, with, with, without.
            rates = {}
            for m in (None, mesh, mesh, None):
                _, _, t, _ = drive(mid, str(work / "turns.tif"), target,
                                   method=method, estimation=est,
                                   batch=SLIDE_BATCH, mesh=m)
                rates.setdefault(m is not None, []).append(
                    n_mid / t["total"])
            if route == "K3":
                src = sl.fit_slide(mid, device=dev)
                plain = mf.normalize_with_matrix_ref(
                    xt, src.stain_matrix, src.max_c, *tp)
            else:
                plain = mf.macenko_normalize_ref(xt, *tp)
            assert np.array_equal(got, assemble(coords, plain.cpu().numpy(),
                                                W, H)), (route, "plain")
            log(47, f"normalize_slide(mesh=make_mesh()) {SLIDE_MID}^2 "
                    f"{route} ({method}, estimation={est}), {n_mid} tiles: "
                    f"{route} launches {launches[f'{route}_mesh_slide']}; "
                    f"level 0 equals the run without a mesh and the plain "
                    f"version byte for byte; end to end in turns (without, "
                    f"with, with, without) {rates[True][0]:.1f} / "
                    f"{rates[True][1]:.1f} tiles/s with the mesh, "
                    f"{rates[False][0]:.1f} / {rates[False][1]:.1f} without; "
                    f"card '{smi}'")
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
    return launches


# ---- Phases 48-51: the flow + GMM colour model and its trainer ------------
# No kernel of K1-K10 runs here: the flow's convolutions are cuDNN's
# (float32; the package turns TF32 off), as the JAX package's are XLA's
# outside any Pallas kernel, but for the residual branches of a forward
# without its log-determinant and without autograd, which F1 computes.
FLOW_SMALL = dict(image_size=16, n_scales=2, blocks_per_scale=2, hidden=8,
                  n_power_series=3, lr=1e-3, warmup_iters=0)
FLOW_BATCH, FLOW_STEPS = 8, 10  # reference_capacity() at its published batch
FLOW_CAPACITY_PARAMS = 502_855  # reference_capacity()'s parameter count
# bench.py:427-468's flow configuration and batch.
FLOW_BENCH = dict(image_size=32, n_scales=2, blocks_per_scale=2, hidden=32,
                  n_clusters=4, warmup_iters=10)
FLOW_BENCH_BATCH, FLOW_BENCH_STEPS = 64, 20


def _tree_diff(a, b, relative=False) -> float:
    """Largest |a - b| over the tensor leaves of two pytrees (divided by
    each leaf's largest |b| where ``relative``), on the CPU."""
    from torch.utils._pytree import tree_leaves

    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if isinstance(x, torch.Tensor):
            x, y = x.detach().cpu().double(), y.detach().cpu().double()
            d = float((x - y).abs().max()) if x.numel() else 0.0
            if relative:
                d /= max(float(y.abs().max()), 1e-30)
            worst = max(worst, d)
    return worst


def _tree_equal(a, b) -> bool:
    from torch.utils._pytree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def flow_phases(dev, smi, work: Path, big: str) -> dict:
    """Phases 48-51: the flow + GMM colour model (``models/``) and its
    trainer on the card. 48, a small flow on the card against the CPU with
    the same weights and probes; 49, ``reference_capacity()`` (502,855
    parameters, 256^2, batch 8) trained for 10 steps, timed, traced,
    replayed for determinism and resumed from a checkpoint; 50,
    ``bench.py --config flow``'s shape; 51, ``scripts/torch_train_flow.py``
    on the 16,384^2 slide of phase 41 with its polygon of phase 46, then
    ``--resume``; then phases 52-68. Returns :func:`rest_phases`' launches
    and F1's over phases 48-56 (``F1_flow``)."""
    from torch.func import functional_call
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._pytree import tree_map

    from stainlib_tpu_torch.data import synthetic
    from stainlib_tpu_torch.kernels import flow_branch as fb
    from stainlib_tpu_torch.models import train_flow as tf
    from stainlib_tpu_torch.ops.colorspace import rgb_to_hsd
    from stainlib_tpu_torch.utils import checkpoint as ck

    def on(state, d):
        """A FlowState on device ``d``, its probes' seed ``SEED``."""
        moved = tree_map(lambda t: t.to(d) if isinstance(t, torch.Tensor)
                         else t, state._replace(rng=None))
        return moved._replace(rng=tf.rng_state(SEED))

    def d01(hsd):
        return torch.clamp(hsd[..., 2:3] / 4.0, 1e-4, 1 - 1e-4).permute(
            0, 3, 1, 2)

    def cohort(n, side, seed):
        """``n`` uint8 tiles of the synthetic cohort, four centers, in a
        seeded order (so that every batch mixes the centers)."""
        rgb = np.concatenate([synthetic.center_tiles(
            c, n // 4, side, side, seed=seed + c) for c in range(4)])
        return rgb[np.random.default_rng(seed).permutation(len(rgb))]

    f1_before = fb.launches  # F1 over phases 48-56
    # 48. A small flow on the card against the CPU: the same converted
    # weights, the same probes. Tolerances: z atol 1e-4, delta_logp rtol
    # 1e-4, the loss rtol 1e-5 (cuDNN's convolutions round otherwise than
    # the CPU's),
    # each gradient leaf 1e-3 of its largest value, the parameters after
    # one Adam step within the learning rate (Adam's first step is
    # lr * g / (|g| + eps), which moves a near-zero gradient's rounding to
    # a full step), the inverse round trip 1e-4.
    cfg = tf.FlowConfig(**FLOW_SMALL)
    hsd_c = rgb_to_hsd(torch.from_numpy(cohort(8, 16, SEED + 48)))
    flow_c, gmm_c, st_c, tx = tf.init_flow_state(cfg, SEED, hsd_c, "cpu")
    flow_g, gmm_g = tf.build_models(cfg, dev)
    st_g, hsd_g = on(st_c, dev), hsd_c.to(dev)
    probes_c = flow_c.draw_probes(d01(hsd_c).shape,
                                  torch.Generator().manual_seed(SEED))
    probes_g = [p.to(dev) for p in probes_c]
    fwd = {}
    for name, f, st, x, pr in (("cpu", flow_c, st_c, hsd_c, probes_c),
                               ("card", flow_g, st_g, hsd_g, probes_g)):
        with torch.no_grad():
            z, dl = functional_call(f, {**st.params["flow"], **st.spectral},
                                    (d01(x),), {"probes": pr})
        fwd[name] = (z, dl)
    loss_c, g_c = tf.loss_and_grads(flow_c, gmm_c, cfg, st_c.params,
                                    st_c.spectral, hsd_c, probes_c)
    loss_g, g_g = tf.loss_and_grads(flow_g, gmm_g, cfg, st_g.params,
                                    st_g.spectral, hsd_g, probes_g)
    new_c, _ = tf.make_train_step(flow_c, gmm_c, cfg, tx)(st_c, hsd_c,
                                                          probes_c)
    new_g, _ = tf.make_train_step(flow_g, gmm_g, cfg, tx)(st_g, hsd_g,
                                                          probes_g)
    flow_g.load_state_dict({**st_g.params["flow"], **st_g.spectral})
    with torch.no_grad():
        back = flow_g.inverse(fwd["card"][0])
    err = dict(
        z=_tree_diff(fwd["card"][0], fwd["cpu"][0]),
        delta_logp=_tree_diff(fwd["card"][1], fwd["cpu"][1], True),
        loss=abs(float(loss_g) - float(loss_c)) / abs(float(loss_c)),
        grads=_tree_diff(g_g, g_c, True),
        params=_tree_diff(new_g.params, new_c.params),
        spectral=_tree_diff(new_g.spectral, new_c.spectral),
        inverse=_tree_diff(back, d01(hsd_g)))
    log(48, "small flow (16^2, 2 scales x 2 blocks, hidden 8, 3 series "
            "terms, batch 8) card against CPU, same weights and probes: "
            + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
            + f" (z, params, spectral, inverse: max abs; delta_logp, loss, "
              f"grads: relative); card '{smi}'")
    assert err["z"] <= 1e-4 and err["delta_logp"] <= 1e-4, err
    assert err["loss"] <= 1e-5 and err["grads"] <= 1e-3, err
    assert err["params"] <= cfg.lr * 1.01 and err["inverse"] <= 1e-4, err
    assert err["spectral"] <= 1e-4, err

    # 49. reference_capacity() on the card: 10 steps at 256^2, batch 8.
    cfg = tf.reference_capacity()
    pool = rgb_to_hsd(torch.from_numpy(
        cohort(FLOW_BATCH * FLOW_STEPS, cfg.image_size, SEED + 49)).to(dev))
    batches = [pool[i * FLOW_BATCH:(i + 1) * FLOW_BATCH]
               for i in range(FLOW_STEPS)]
    flow, gmm, st0, tx = tf.init_flow_state(cfg, SEED, batches[0], dev)
    n_params = sum(p.numel() for part in st0.params.values()
                   for p in part.values())
    assert n_params == FLOW_CAPACITY_PARAMS, n_params
    step = tf.make_train_step(flow, gmm, cfg, tx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st, loss = step(st0, batches[0])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    losses, states = [loss], [st]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for i in range(1, FLOW_STEPS):
        st, loss = step(st, batches[i])
        losses.append(loss)
        states.append(st)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1]) / (FLOW_STEPS - 1)
    peak = torch.cuda.max_memory_allocated()
    bpd = [float(v) for v in losses]
    assert all(np.isfinite(bpd)), bpd
    log(49, f"reference_capacity(): {n_params:,} parameters, {cfg.image_size}"
            f"^2, batch {FLOW_BATCH}, {FLOW_STEPS} steps, bpd "
            f"{bpd[0]:.4f} -> {bpd[-1]:.4f} (all finite); first step "
            f"{first_s:.2f} s; steps 2-{FLOW_STEPS} {ms:.1f} ms/step = "
            f"{FLOW_BATCH * 1e3 / ms:.2f} imgs/s (CUDA events); peak "
            f"allocated {peak / 2**30:.2f} GiB; card '{smi}'")

    # Where the time goes: two steps traced on the device.
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[:2]:
            st, _ = step(st, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    acts = trace_activities(prof)
    busy = sum(ms_ for _, ms_ in acts.values())
    top = sorted(acts.items(), key=lambda kv: -kv[1][1])[:5]
    log(49, f"two traced steps: {wall_ms:.1f} ms on the host clock, device "
            f"busy {busy:.1f} ms, idle {1 - busy / wall_ms:.2%}; top device "
            f"activities: " + "; ".join(
                f"{k[:70]} x{n} {t:.1f} ms ({t / busy:.1%})"
                for k, (n, t) in top))

    # Determinism: the same three steps twice from one state.
    def replay():
        s, out = states[-1], []
        for b in batches[:3]:
            s, l = step(s, b)
            out.append(l)
        torch.cuda.synchronize()
        return out, s

    def replay_ms():
        e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        e[0].record()
        replay()
        e[1].record()
        torch.cuda.synchronize()
        return e[0].elapsed_time(e[1]) / 3

    (la, sa), (lb, sb) = replay(), replay()
    same = _tree_equal(la, lb) and _tree_equal(sa, sb)
    msg = (f"the same three steps twice from one state: losses and state "
           f"{'bit-identical' if same else 'differ'} (max |diff| params "
           f"{_tree_diff(sa.params, sb.params):.3e}, losses "
           f"{_tree_diff(la, lb):.3e}); default cuDNN {replay_ms():.1f} "
           f"ms/step")
    if not same:
        with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                        benchmark=False):
            (la, sa), (lb, sb) = replay(), replay()
            det = _tree_equal(la, lb) and _tree_equal(sa, sb)
            msg += (f"; under cudnn.deterministic "
                    f"{'bit-identical' if det else 'still differ'}, "
                    f"{replay_ms():.1f} ms/step")
    log(49, msg)

    # Checkpoint at step 5, restore into a state from another seed, take
    # step 6: the uninterrupted run's loss, bit for bit.
    ck.save_checkpoint(str(work / "flow_ckpt"), states[4], states[4].step)
    _, _, fresh, _ = tf.init_flow_state(cfg, SEED + 1, batches[1], dev)
    restored = ck.restore_checkpoint(str(work / "flow_ckpt"), fresh)
    assert restored.step == 5 and _tree_equal(restored, states[4])
    r6, loss6 = step(restored, batches[5])
    assert torch.equal(loss6, losses[5]), (float(loss6), bpd[5])
    # The 10-step state, which phases 53-56 deploy.
    ck.save_checkpoint(str(work / "capacity_ckpt"), states[-1],
                       states[-1].step)

    # The inverse on 2 tiles: z = flow(x), x' = flow.inverse(z).
    flow.load_state_dict({**st.params["flow"], **st.spectral})
    x = d01(batches[0][:2])
    with torch.no_grad():
        back = flow.inverse(flow(x, skip_logdet=True)[0])
    inv = float((back - x).abs().max())
    log(49, f"checkpoint at step 5 restored into a fresh state: step 6's "
            f"loss {float(loss6):.6f} equals the uninterrupted run's; "
            f"inverse(forward(x)) on 2 tiles max |err| {inv:.3e}")
    assert inv <= 1e-3, inv

    # 50. bench.py --config flow's shape: 32^2, 2 scales x 2 blocks,
    # hidden 32, batch 64; imgs/s over a chain of steps after the first.
    cfg = tf.FlowConfig(**FLOW_BENCH)
    hsd = rgb_to_hsd(torch.from_numpy(
        tiles(FLOW_BENCH_BATCH, 32, SEED + 50)).to(dev))
    flow, gmm, st, tx = tf.init_flow_state(cfg, SEED, hsd, dev)
    step = tf.make_train_step(flow, gmm, cfg, tx)
    st, loss = step(st, hsd)
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(FLOW_BENCH_STEPS):
        st, loss = step(st, hsd)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1]) / FLOW_BENCH_STEPS
    assert np.isfinite(float(loss))
    log(50, f"bench.py --config flow's shape (32^2, 2 scales x 2 blocks, "
            f"hidden 32, batch {FLOW_BENCH_BATCH}): {ms:.2f} ms/step = "
            f"{FLOW_BENCH_BATCH * 1e3 / ms:.1f} imgs/s over "
            f"{FLOW_BENCH_STEPS} chained steps (CUDA events); card '{smi}'")

    # 51. The training CLI on the slide, then --resume.
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, str(root / "scripts" / "torch_train_flow.py"),
           "--slides", big, "--xmls", str(work / "slide16k.xml"),
           "--image-size", "64", "--batch", "16", "--steps", "6",
           "--save-every", "3", "--device", dev.type,
           "--save", str(work / "cli_ckpt")]
    runs = []
    for extra in ([], ["--resume"]):
        t0 = time.perf_counter()
        r = subprocess.run(cmd + extra, capture_output=True, text=True,
                           timeout=300, cwd=root)
        runs.append(time.perf_counter() - t0)
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
        out = r.stdout
    assert "resumed at step 6" in out and "step 7: bpd" in out, out
    assert ck.latest_step(str(work / "cli_ckpt")) == 12
    log(51, f"scripts/torch_train_flow.py on the {SLIDE_SIDE:,}^2 slide with "
            f"its tumor polygon, 64^2 tiles, batch 16: 6 steps with a "
            f"checkpoint every 3 ({runs[0]:.1f} s), then --resume from step "
            f"6 to 12 ({runs[1]:.1f} s); both exit 0")

    # 52-56. Deployment and evaluation of the trained model.
    deploy_phases(dev, smi, work, st_c)
    f1 = fb.launches - f1_before
    assert f1 > 0 and f1 % 15 == 0, f1
    log(56, f"F1 launches over phases 48-56: {f1} ({f1 // 15} deploy "
            f"encodes of 15 residual branches at capacity; training, the "
            f"inverse and the small flows run lipschitz_apply)")
    # 57-62. Cross-device checkpoints, the segmenter, DANN, their CLIs.
    model_phases(dev, smi, work)
    # 63-68. utils, the data CLIs, the scale drive, examples, the launcher.
    launches = rest_phases(dev, smi, work, big)
    launches["F1_flow"] = f1
    return launches


# ---- Flow deployment and evaluation (phases 52-56) --------------------------
# No kernel of K1-K10 runs here either: gamma comes from the flow's forward
# with the logdet skipped (at capacity its residual branches are F1's, the
# rest cuDNN float32 convolutions); the transfers and the statistics are
# plain PyTorch, as the JAX package's are plain jnp.
DEPLOY_TOL = dict(rtol=1e-5, atol=1e-6)  # template statistics, card vs CPU
TOY_ITERS = 200


def _events():
    return [torch.cuda.Event(enable_timing=True) for _ in range(2)]


def _u8_diff(a, b) -> np.ndarray:
    return np.abs(np.asarray(a).astype(np.int16)
                  - np.asarray(b).astype(np.int16))


def _timed(parts: dict, name: str, fn):
    """``fn`` timed by CUDA events into ``parts[name]`` (ms; a list, one
    entry per call)."""
    def run(*a, **k):
        e = _events()
        torch.cuda.synchronize()
        e[0].record()
        out = fn(*a, **k)
        e[1].record()
        torch.cuda.synchronize()
        parts.setdefault(name, []).append(e[0].elapsed_time(e[1]))
        return out
    return run


@contextlib.contextmanager
def _patched(module, **fns):
    real = {n: getattr(module, n) for n in fns}
    for n, f in fns.items():
        setattr(module, n, f)
    try:
        yield real
    finally:
        for n, f in real.items():
            setattr(module, n, f)


def deploy_phases(dev, smi, work: Path, small) -> None:
    """Phases 52-56: the flow colour model's deployment and evaluation
    (``models/validate_flow.py``, ``models/color_eval.py``,
    ``normalization/slide.flow_normalize_slide``, ``models/sampling.py``,
    ``models/toy.py`` and their CLIs). 52, ``validate`` with the six
    transfers for phase 48's small flow (``small``, its CPU state) on the
    card against the CPU; 53, ``validate`` with the six transfers at
    ``reference_capacity()`` from phase 49's 10-step checkpoint, timed,
    traced; 54, ``flow_normalize_slide`` on phase 44's 4096^2 slide, four
    transfers with class matching off and on, the diag route twice; 55,
    ``sample_flow`` at capacity and the toy flow; 56, the CLIs."""
    from torch.func import functional_call
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._pytree import tree_map

    from stainlib_tpu_torch.data import native, synthetic
    from stainlib_tpu_torch.kernels import flow_branch as fb
    from stainlib_tpu_torch.models import train_flow as tf
    from stainlib_tpu_torch.models import validate_flow as vf
    from stainlib_tpu_torch.models.sampling import (
        flow_inverse, sample_flow, save_sample_grid)
    from stainlib_tpu_torch.models.toy import (
        ToyConfig, ToyResFlow, sample_toy, train_toy)
    from stainlib_tpu_torch.normalization import flow as nflow
    from stainlib_tpu_torch.normalization import slide as sl
    from stainlib_tpu_torch.ops.colorspace import rgb_to_hsd
    from stainlib_tpu_torch.utils import checkpoint as ck

    t_phases = time.perf_counter()

    def quiet(*_):
        pass

    def n_params(params):
        return sum(p.numel() for part in params.values()
                   for p in part.values())

    # 52. Phase 48's small flow, the same weights on the card and the CPU:
    # validate with each transfer, class matching on, 2 template and 2
    # test batches of 8 tiles of 16^2 from four centers. Tolerances: the
    # template statistics rtol 1e-5, atol 1e-6; the uint8 outputs within 1
    # on all but 1e-3 of the bytes, at most 2; NMI within 1e-5 on the
    # images whose bytes are equal.
    cfg = tf.FlowConfig(**FLOW_SMALL)
    rgb, _ = synthetic.multi_center_batches(range(4), 8, 8, 16, 16,
                                            seed=SEED + 52)
    hsd = [rgb_to_hsd(torch.from_numpy(b)) for b in rgb]
    models = {"cpu": (*tf.build_models(cfg, "cpu"), small.params,
                      small.spectral),
              "card": (*tf.build_models(cfg, dev),
                       tree_map(lambda t: t.to(dev), small.params),
                       tree_map(lambda t: t.to(dev), small.spectral))}
    for transfer in vf.TRANSFERS:
        res = {where: vf.validate(f, g, cfg, p, sp, hsd[:2], hsd[2:],
                                  log=quiet, transfer=transfer,
                                  class_match=True)
               for where, (f, g, p, sp) in models.items()}
        a, b = res["card"], res["cpu"]
        stat_err = {}
        for name in ("mu", "sigma", "cov", "quantiles", "usage"):
            x, y = getattr(a["stats"], name), getattr(b["stats"], name)
            if y is None:
                continue
            stat_err[name] = float(np.abs(x - y).max())
            assert np.allclose(x, y, **DEPLOY_TOL), (transfer, name)
        d = np.concatenate([_u8_diff(x, y).reshape(len(x), -1)
                            for x, y in zip(a["outputs"], b["outputs"])])
        same = d.max(1) == 0
        nmi_err = np.abs(np.asarray(a["nmi"]) - np.asarray(b["nmi"]))
        log(52, f"validate(transfer={transfer!r}, class_match=True), small "
                f"flow, card against CPU: template statistics max |diff| "
                + ", ".join(f"{k} {v:.2e}" for k, v in stat_err.items())
                + f" (rtol 1e-5, atol 1e-6); uint8 max |diff| {d.max()}, "
                f"share > 1 {(d > 1).mean():.2e}; {same.sum()} of "
                f"{len(same)} images equal byte for byte, their NMI max "
                f"|diff| {nmi_err[same].max() if same.any() else 0:.2e}; "
                f"NMI card {np.round(a['nmi'], 5).tolist()}; card '{smi}'")
        assert d.max() <= 2 and (d > 1).mean() <= 1e-3, (transfer, d.max())
        assert (nmi_err[same] <= 1e-5).all(), (transfer, nmi_err)

    # 53. reference_capacity() from phase 49's 10-step checkpoint (EMA
    # weights): validate with each transfer over 4 template batches of
    # center 0 and 4 test batches from four centers, 8 tiles of 256^2.
    cfg = tf.reference_capacity()
    S, B8 = cfg.image_size, FLOW_BATCH
    tmpl_rgb = synthetic.center_tiles(0, 4 * B8, S, S, seed=SEED + 53)
    test_rgb, _ = synthetic.multi_center_batches(range(4), B8, B8, S, S,
                                                 seed=SEED + 153)
    tmpl = [rgb_to_hsd(torch.from_numpy(tmpl_rgb[i * B8:(i + 1) * B8])
                       .to(dev)) for i in range(4)]
    test = [rgb_to_hsd(torch.from_numpy(b).to(dev)) for b in test_rgb]
    flow, gmm, template, _ = tf.init_flow_state(cfg, SEED + 2, tmpl[0], dev)
    state = ck.restore_checkpoint(str(work / "capacity_ckpt"), template)
    params, spectral = state.ema.params, state.spectral
    assert state.step == FLOW_STEPS, state.step
    assert n_params(params) == FLOW_CAPACITY_PARAMS, n_params(params)
    before = fb.launches
    g_only = vf.encode_gamma(flow, gmm, params, spectral, test[0])
    n_f1 = fb.launches - before
    assert n_f1 == cfg.n_scales * cfg.blocks_per_scale == 15, n_f1
    _, _, g_enc = tf.encode(flow, gmm, params, spectral, cfg, test[0],
                            generator=torch.Generator(dev).manual_seed(SEED))
    assert torch.equal(g_only, g_enc.permute(0, 2, 3, 1)), (
        "the gamma-only route differs from encode's gamma")
    log(53, f"reference_capacity() restored at step {state.step} (EMA "
            f"weights, {n_params(params):,} parameters): the gamma-only "
            f"route (logdet skipped; F1 launches {n_f1}, one per residual "
            f"branch) equals encode's gamma bit for bit on a batch of {B8} "
            f"tiles of {S}^2")
    del g_enc
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_test = len(test) * B8
    for transfer in vf.TRANSFERS:
        parts = {}
        with _patched(vf, deploy=_timed(parts, "deploy", vf.deploy),
                      accumulate_template_sums=_timed(
                          parts, "template", vf.accumulate_template_sums)):
            res = vf.validate(flow, gmm, cfg, params, spectral, tmpl, test,
                              log=quiet, transfer=transfer)
        assert all(o.dtype == np.uint8 and o.shape == (B8, S, S, 3)
                   for o in res["outputs"])
        assert np.isfinite(res["nmi"]).all()
        # The recolour step alone (gamma, the batch's statistics, the
        # transfer), a chain over the 4 test batches, no host work.
        st = res["stats"]
        dev_stats = [None if t is None else torch.from_numpy(t).to(dev)
                     for t in (st.mu, st.sigma, st.cov, st.quantiles)]
        q_space = "rgb" if transfer.startswith("rgb-") else "hsd"
        composite = transfer.endswith("full-quantile")
        e = _events()
        e[0].record()
        for h in test:
            g = vf.encode_gamma(flow, gmm, params, spectral, h)
            vf.transfer_batch(h, g, dev_stats[0], dev_stats[1], None,
                              dev_stats[2], dev_stats[3], q_space, composite)
        e[1].record()
        torch.cuda.synchronize()
        step_ms = e[0].elapsed_time(e[1]) / len(test)
        log(53, f"validate(transfer={transfer!r}) at capacity: deploy pass "
                f"{n_test * 1e3 / parts['deploy'][0]:.1f} imgs/s "
                f"({parts['deploy'][0]:.1f} ms for {n_test} tiles, the host's "
                f"per-class NMI included); template pass "
                f"{parts['template'][0]:.1f} ms for {4 * B8} tiles; the "
                f"recolour step alone {step_ms:.1f} ms per batch of {B8} = "
                f"{B8 * 1e3 / step_ms:.1f} imgs/s (CUDA events); NMI sd "
                f"{res['nmi_sd']:.4f} cv {res['nmi_cv']:.4f}; per-class NMI "
                f"sd/cv raw {res['class_nmi_sd_raw']:.4f}/"
                f"{res['class_nmi_cv_raw']:.4f} -> normalized "
                f"{res['class_nmi_sd']:.4f}/{res['class_nmi_cv']:.4f} "
                f"(a 10-step checkpoint: plumbing, not colour quality); "
                f"card '{smi}'")
    peak = torch.cuda.max_memory_allocated()
    log(53, f"peak allocated over the six validate runs "
            f"{peak / 2**30:.2f} GiB")

    # The diag deploy pass traced: the idle share, the five longest device
    # activities.
    stats = vf.accumulate_template_stats(flow, gmm, cfg, params, spectral,
                                         tmpl)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        vf.deploy(flow, gmm, cfg, params, spectral, test, stats.mu,
                  stats.sigma, log=quiet)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    acts = trace_activities(prof)
    busy = sum(ms_ for _, ms_ in acts.values())
    top = sorted(acts.items(), key=lambda kv: -kv[1][1])[:5]
    log(53, f"diag deploy pass traced ({n_test} tiles): {wall_ms:.1f} ms on "
            f"the host clock, device busy {busy:.1f} ms, idle "
            f"{1 - busy / wall_ms:.2%}; top device activities: " + "; ".join(
                f"{k[:70]} x{n} {t:.1f} ms ({t / max(busy, 1e-9):.1%})"
                for k, (n, t) in top))

    # 54. flow_normalize_slide on phase 44's 4096^2 slide (256 tiles) at
    # capacity, batch 8; four transfers, class matching off then on; the
    # diag route again, traced. The host has no libtiff: the writer is
    # not run and level 0 is read from the canvas.
    tiff = native.tiff_native_available()
    mid = str(work / "mid.wsiraw")
    n_mid = (SLIDE_MID // S) ** 2
    runs = [(t, cm) for t in sl.FLOW_TRANSFERS for cm in (False, True)]
    runs.append(("diag", False))
    canvases = []
    real_stream = sl._stream_canvas
    for i, (transfer, cm) in enumerate(runs):
        parts, seen = {}, {}
        traced = i == len(runs) - 1

        def stream(*a, **k):
            if traced:
                with profile(activities=[ProfilerActivity.CUDA]) as p:
                    out = _timed(parts, "stream", real_stream)(*a, **k)
                seen["prof"] = p
            else:
                out = _timed(parts, "stream", real_stream)(*a, **k)
            seen["canvas"] = out[0]
            return out

        write = (_timed(parts, "write", sl.write_tiff_pyramid) if tiff
                 else (lambda *a, **k: None))
        # flow_normalize_slide's statistics are FlowNormalizer's, which
        # looks the function up in its own module.
        with _patched(nflow, accumulate_template_stats=_timed(
                parts, "stats", nflow.accumulate_template_stats)), \
                _patched(sl, _stream_canvas=stream,
                         build_pyramid=_timed(parts, "pyramid",
                                              sl.build_pyramid),
                         write_tiff_pyramid=write):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            info = sl.flow_normalize_slide(
                mid, str(work / f"flow_{transfer}.tif"),
                str(work / "capacity_ckpt"), batch=B8, cfg=cfg,
                class_match=cm, transfer=transfer, device=dev)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        out = seen["canvas"]
        assert info["tiles"] == n_mid and out.shape == (SLIDE_MID,
                                                        SLIDE_MID, 3)
        assert out.dtype == np.uint8 and info["params"] == \
            FLOW_CAPACITY_PARAMS and info["step"] == FLOW_STEPS
        canvases.append(out)
        split = (f"template stats {parts['stats'][0]:.0f} ms, source stats "
                 f"{parts['stats'][1]:.0f} ms, stream "
                 f"{parts['stream'][0]:.0f} ms, pyramid "
                 f"{parts['pyramid'][0]:.0f} ms, writer "
                 + (f"{parts['write'][0]:.0f} ms" if tiff
                    else "not run (no libtiff)"))
        msg = (f"flow_normalize_slide {SLIDE_MID}^2 ({n_mid} tiles), "
               f"transfer={transfer!r}, class_match={cm}, batch {B8}: "
               f"{n_mid / total:.2f} tiles/s end to end ({total:.2f} s: "
               f"{split}; host clock, CUDA events per part)")
        if traced:
            acts = trace_activities(seen["prof"])
            busy = sum(ms_ for _, ms_ in acts.values())
            stream_ms = parts["stream"][0]
            same = np.array_equal(out, canvases[0])
            assert same, "two diag runs differ"
            msg += (f"; a second diag run: the same bytes; its stream traced:"
                    f" device busy {busy:.1f} ms of {stream_ms:.1f} ms, idle "
                    f"{1 - busy / stream_ms:.2%}")
        log(54, msg + f"; card '{smi}'")
    q = SLIDE_MID // 4
    lv0 = native.open_slide(mid)
    src = lv0.read_region(0, q, q, q, q)
    lv0.close()
    moved = np.abs(canvases[0][q:2 * q, q:2 * q].astype(np.int16) - src)
    assert moved.mean() > 0.5, "the recolouring did not move the tissue"
    del canvases

    # 55. sample_flow at capacity: n=4 from the GMM mixture, then the round
    # trip inverse(forward(x)) of the samples; the toy flow trained on the
    # card, and its forward and logdet on the card against the CPU.
    variables = {**params["flow"], **spectral}
    gp = params["gmm"]
    x = sample_flow(flow, variables, 4,
                    torch.Generator(dev).manual_seed(SEED + 55),
                    gmm_params={"mu": gp["mu"],
                                "sigma": torch.exp(gp["log_sigma"])})
    assert x.shape == (4, 1, S, S) and torch.isfinite(x).all()
    def forward(v):
        with torch.no_grad():
            return functional_call(flow, variables, (v,),
                                   {"skip_logdet": True})[0]

    # The samples' latents z = forward(x); x' = inverse(z), z' = forward(x').
    # x' is held as scripts/sample_flow_capacity.py holds it; z' - z is
    # reported (the logit layer scales an error in x by up to 1e4 near the
    # clip at 1e-4).
    z2 = forward(torch.clamp(x, 1e-4, 1 - 1e-4))
    x2 = flow_inverse(flow, variables, z2)
    err = float((torch.clamp(x2, 0, 1) - x).abs().max())
    lat_err = float((forward(x2) - z2).abs().max())
    assert err < 5e-2 and np.isfinite(lat_err), (err, lat_err)
    lines = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toy, _, nll = train_toy(ToyConfig(n_iters=TOY_ITERS), seed=SEED % 1000,
                            log=lines.append, device=dev)
    toy_s = time.perf_counter() - t0
    first = float(lines[0].split("nll")[1])
    assert np.isfinite(nll) and nll < first, (first, nll)
    cpu_toy = ToyResFlow(device="cpu")
    cpu_toy.load_state_dict({k: v.cpu() for k, v in toy.state_dict().items()})
    pts = torch.from_numpy(sample_toy("8gaussians", 512, seed=SEED % 1000))
    (zc, lc), (zg, lg) = cpu_toy(pts), toy(pts.to(dev))
    z_err = float((zg.detach().cpu() - zc.detach()).abs().max())
    l_err = float((lg.detach().cpu() - lc.detach()).abs().max())
    assert z_err <= 1e-4 and l_err <= 1e-4, (z_err, l_err)
    try:
        import PIL  # noqa: F401  (save_visuals and save_sample_grid need it)
        pil = True
    except ImportError:
        pil = False
    if pil:
        grid = save_sample_grid(str(work / "samples.png"), x, cols=4)
        vf.save_visuals(str(work / "visuals"), state.step, tmpl[0], test[0],
                        res["outputs"][0],
                        vf.encode_gamma(flow, gmm, params, spectral,
                                        test[0]))
        assert Path(grid).exists() and len(list(
            (work / "visuals").glob("im_*.png"))) == 4
        log(55, "PIL is on this host: save_sample_grid and save_visuals "
                "wrote their PNGs")
    else:
        log(55, "PIL is not on this host: save_sample_grid and "
                "save_visuals are not run here (the CPU tests hold them)")
    log(55, f"sample_flow at capacity, n=4 from the GMM mixture: "
            f"{tuple(x.shape)} in [{float(x.min()):.3f}, "
            f"{float(x.max()):.3f}], inverse(forward(x)) max |err| "
            f"{err:.3e}, forward(inverse(z)) max |err| {lat_err:.3e}; "
            f"train_toy 8gaussians {TOY_ITERS} iterations on the "
            f"card ({toy_s:.1f} s): nll {first:.4f} -> {nll:.4f}; the "
            f"trained ToyResFlow on 512 points, card against CPU: z max "
            f"|diff| {z_err:.2e}, logdet {l_err:.2e} (atol 1e-4)")

    # 56. The CLIs as subprocesses: --evaluate on phase 51's checkpoint,
    # and the deploy-rate script on phase 49's.
    root = Path(__file__).resolve().parent
    ev = [sys.executable, str(root / "scripts" / "torch_train_flow.py"),
          "--evaluate", "--image-size", "64", "--batch", "16",
          "--device", dev.type, "--save", str(work / "cli_ckpt")]
    bench = [sys.executable,
             str(root / "scripts" / "torch_bench_flow_deploy.py"),
             "--ckpt", str(work / "capacity_ckpt"), "--iters", "3",
             "--transfers", ",".join(vf.TRANSFERS), "--device", dev.type,
             "--out", str(work / "bench_flow_deploy.json")]
    outs = []
    for cmd in (ev, bench):
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                           cwd=root)
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
        outs.append((r.stdout, time.perf_counter() - t0))
    assert "resumed at step 12" in outs[0][0] and "NMI sd=" in outs[0][0]
    rates = json.loads(outs[1][0].strip().splitlines()[-1])
    assert set(rates) == set(vf.TRANSFERS)
    nmi_line = [ln for ln in outs[0][0].splitlines() if "NMI sd=" in ln][-1]
    log(56, f"scripts/torch_train_flow.py --evaluate on phase 51's "
            f"checkpoint ({outs[0][1]:.1f} s): exit 0, "
            f"{nmi_line.split('INFO ')[-1]}; "
            f"scripts/torch_bench_flow_deploy.py --iters 3 on phase 49's "
            f"({outs[1][1]:.1f} s): exit 0, imgs/s per transfer {rates} "
            f"(256^2, batch 8, CUDA events); card '{smi}'")
    log(56, "scripts/torch_flow_normalize_wsi.py is not run here"
            + (": it writes a TIFF, and this host has no libtiff (phase 41)"
               if not tiff else "")
            + "; phase 54 drives flow_normalize_slide itself, and the CPU "
              "tests run the CLI end to end")
    log(56, f"phases 52-56 took {time.perf_counter() - t_phases:.1f} s")


# ---- Phases 57-62: cross-device checkpoints, the segmenter and DANN ---------
# No kernel of K1-K10 runs here: the U-Net, DannCNN and MobileNet are cuDNN
# float32 convolutions and cuBLAS matmuls (TF32 off), as the JAX package's
# are XLA's; the seg demo's Macenko, Vahadane and Reinhard conditions call
# the functional paths, as the JAX script does.
SEG_CFG = dict(base=16, depth=3)  # scripts/seg_transfer_demo.py's widths
SEG_SIDE, SEG_BATCH, SEG_TILES = 64, 32, 192
SEG_STEPS = (10, 60)  # two runs; ms/step from their difference
DANN_BATCH, DANN_ITERS = 64, 30  # DannConfig's batch; 63^2 patches
MOBILENET_SIDE, MOBILENET_BATCH, MOBILENET_ITERS = 224, 64, 10
MOBILENET_TRUNK = 829_536  # keras MobileNet(alpha=0.5)'s count
CAPACITY_CLI = ("--iters", 5)  # phase 61: 224^2, batch 64, 5 iterations


def _has_pil() -> bool:
    return importlib.util.find_spec("PIL") is not None


def _peak_text(base: int) -> str:
    """The peak allocation since the last reset, and its part above
    ``base``, the bytes allocated then (earlier phases' tensors)."""
    peak = torch.cuda.max_memory_allocated()
    return (f"peak allocated {peak / 2**30:.3f} GiB, "
            f"{(peak - base) / 2**30:.3f} GiB above the "
            f"{base / 2**30:.3f} GiB allocated at its start")


def _rel_leaf(got: dict, want: dict) -> float:
    """Largest |got - want| over each leaf's largest |want|, on the CPU."""
    worst = 0.0
    for k, w in want.items():
        w = w.detach().cpu().double()
        g = got[k].detach().cpu().double()
        worst = max(worst, float((g - w).abs().max())
                    / max(float(w.abs().max()), 1e-30))
    return worst


def model_phases(dev, smi, work: Path) -> None:
    """Phases 57-62: 57, phase 49's card checkpoint restored on the CPU,
    saved there, restored on the card: the same state, the same gamma
    bytes, the same next loss; 58, the U-Net (``models/segmentation.py``)
    on the card against the CPU, then ``train_segmenter`` at the seg
    demo's widths (base 16, depth 3, 64^2, batch 32), timed; 59,
    ``DannCNN`` on the card against the CPU (each phase's loss, gradients
    and statistics), then its three-phase iteration at batch 64, timed;
    60, ``MobileNetDann`` (alpha 0.5, its trunk 829,536) at 224^2, batch
    64, timed and traced; 61, the six CLIs as subprocesses at small step
    counts, the probe and the seg demo's ``--capacity-ckpt`` on phase 49's
    checkpoint and on the CPU-saved one; 62, ``sliding_window_scores`` and
    ``mine_hard_negatives`` with phase 59's model on a 1024^2 field."""
    from torch.profiler import ProfilerActivity, profile

    from stainlib_tpu_torch.data import generators, synthetic
    from stainlib_tpu_torch.models import backbones as bb
    from stainlib_tpu_torch.models import dann as dn
    from stainlib_tpu_torch.models import segmentation as sg
    from stainlib_tpu_torch.models import train_flow as tf
    from stainlib_tpu_torch.models import validate_flow as vf
    from stainlib_tpu_torch.ops.colorspace import rgb_to_hsd
    from stainlib_tpu_torch.utils import checkpoint as ck

    t_phases = time.perf_counter()
    cpu = torch.device("cpu")

    def on(tree, d):
        return {k: v.to(d) for k, v in tree.items()}

    # 57. Cross-device restores. Phase 49's 10-step state was saved on the
    # card; restore it into a template made on the CPU, save it there, and
    # restore that into a template made on the card.
    cfg = tf.reference_capacity()
    S = cfg.image_size
    hsd = rgb_to_hsd(torch.from_numpy(synthetic.center_tiles(
        0, FLOW_BATCH, S, S, seed=SEED + 57)).to(dev))
    flow, gmm, card_tmpl, tx = tf.init_flow_state(cfg, SEED + 3, hsd[:2], dev)
    cpu_tmpl = tf.init_flow_state(cfg, SEED + 4, hsd[:2].cpu(), cpu)[2]
    t0 = time.perf_counter()
    card = ck.restore_checkpoint(str(work / "capacity_ckpt"), card_tmpl)
    on_cpu = ck.restore_checkpoint(str(work / "capacity_ckpt"), cpu_tmpl)
    ck.save_checkpoint(str(work / "capacity_ckpt_cpu"), on_cpu, on_cpu.step)
    back = ck.restore_checkpoint(str(work / "capacity_ckpt_cpu"), card_tmpl)
    restore_s = time.perf_counter() - t0
    from torch.utils._pytree import tree_leaves

    assert all(x.device.type == "cpu" for x in tree_leaves(on_cpu)
               if isinstance(x, torch.Tensor))
    assert _tree_equal(back, card), "the CPU round trip changed the state"
    assert card.step == back.step == FLOW_STEPS and card.rng.shape == (2,)
    g_card = vf.encode_gamma(flow, gmm, card.ema.params, card.spectral, hsd)
    g_back = vf.encode_gamma(flow, gmm, back.ema.params, back.spectral, hsd)
    assert torch.equal(g_card, g_back)
    step = tf.make_train_step(flow, gmm, cfg, tx)
    (_, l_card), (_, l_back) = step(card, hsd), step(back, hsd)
    assert torch.equal(l_card, l_back), (float(l_card), float(l_back))
    log(57, f"phase 49's card checkpoint (step {card.step}, rng leaf "
            f"{card.rng.tolist()}, int64 (2,) on every device) restored "
            f"into a CPU template, saved from the CPU, restored into a card "
            f"template ({restore_s:.2f} s for the three): every leaf equal "
            f"to the card's own restore, gamma of {FLOW_BATCH} tiles of "
            f"{S}^2 equal bit for bit, the next step's loss "
            f"{float(l_back):.6f} equal bit for bit")
    del flow, gmm, card_tmpl, cpu_tmpl, card, on_cpu, back, g_card, g_back

    # 58. The U-Net at the seg demo's widths: the card against the CPU on
    # the same weights (logits atol 1e-4, the loss rtol 1e-5, gradients
    # 1e-4 of each leaf's largest value), then train_segmenter timed.
    seg_tiles, seg_masks = synthetic.center_tiles_with_masks(
        0, SEG_TILES, SEG_SIDE, SEG_SIDE, seed=SEED + 58)
    m_cpu, p_cpu = sg.init_unet(3, seed=SEED, device=cpu, **SEG_CFG)
    m_card = sg.UNet(3, device=dev, **SEG_CFG)
    x8 = torch.from_numpy(seg_tiles[:8])
    y8 = torch.from_numpy(seg_masks[:8])
    with torch.no_grad():
        lc = torch.func.functional_call(m_cpu, p_cpu, (sg._unit(x8),))
        lg = torch.func.functional_call(m_card, on(p_cpu, dev),
                                        (sg._unit(x8.to(dev)),))
    logit_err = float((lg.cpu() - lc).abs().max())
    loss_c, g_c = sg.loss_and_grads(m_cpu, p_cpu, x8, y8)
    loss_g, g_g = sg.loss_and_grads(m_card, on(p_cpu, dev), x8.to(dev),
                                    y8.to(dev))
    loss_err = abs(float(loss_g) / float(loss_c) - 1)
    grad_err = _rel_leaf(g_g, g_c)
    assert logit_err <= 1e-4 and loss_err <= 1e-5 and grad_err <= 1e-4, (
        logit_err, loss_err, grad_err)
    n_seg = sum(v.numel() for v in p_cpu.values())
    sg.train_segmenter(seg_tiles, seg_masks, steps=2, batch=SEG_BATCH,
                       seed=SEED, device=dev, **SEG_CFG)  # warm-up
    seg_ms = {}
    for n in SEG_STEPS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        e = _events()
        e[0].record()
        predict, _ = sg.train_segmenter(seg_tiles, seg_masks, steps=n,
                                        batch=SEG_BATCH, seed=SEED,
                                        device=dev, **SEG_CFG)
        e[1].record()
        torch.cuda.synchronize()
        seg_ms[n] = e[0].elapsed_time(e[1])
    seg_peak = _peak_text(base)
    per_step = (seg_ms[SEG_STEPS[1]] - seg_ms[SEG_STEPS[0]]) / (
        SEG_STEPS[1] - SEG_STEPS[0])
    pred = predict(seg_tiles[:SEG_BATCH])
    assert pred.dtype == torch.int32 and pred.shape == (SEG_BATCH, SEG_SIDE,
                                                        SEG_SIDE)
    log(58, f"U-Net base {SEG_CFG['base']} depth {SEG_CFG['depth']} "
            f"({n_seg:,} parameters), card against CPU on 8 tiles of "
            f"{SEG_SIDE}^2: logits max |diff| {logit_err:.2e}, loss "
            f"{loss_err:.2e} relative, gradients {grad_err:.2e} of each "
            f"leaf's largest; train_segmenter batch {SEG_BATCH}, after a "
            f"2-step warm-up: "
            f"{SEG_STEPS[0]} steps {seg_ms[SEG_STEPS[0]]:.1f} ms, "
            f"{SEG_STEPS[1]} steps {seg_ms[SEG_STEPS[1]]:.1f} ms (CUDA "
            f"events, set-up included) -> {per_step:.3f} ms/step = "
            f"{SEG_BATCH * 1e3 / per_step:.1f} tiles/s; {seg_peak}; card "
            f"'{smi}'")

    # 59. DannCNN, the card against the CPU on the same weights with
    # dropout off on both (the card's generator draws other masks), on 64
    # patches uniform in [0, 1]. flax's BatchNorm variance E[x^2] - E[x]^2
    # cancels in float32, so the card and the CPU are each held to the
    # CPU's float64 evaluation of the same step: loss rtol 1e-4, gradients
    # 2e-3 and statistics 1e-4 of each leaf's largest value (on patches
    # whose mean dwarfs their spread, as the timed run's below, float32
    # gradients sit percents from float64 on either device). Then the
    # three-phase iteration at batch 64 on those uint8 patches, timed.
    rng = np.random.default_rng(SEED + 59)
    n_dann = 512
    labels = rng.integers(0, 2, n_dann)
    domains = rng.integers(0, 3, n_dann)
    patches = ((rng.random((n_dann, 63, 63, 3)) * 0.3
                + labels[:, None, None, None] * 0.35) * 255).astype(np.uint8)
    model_c, st_c, tx_d = dn.init_dann(SEED, n_domains=3, device=cpu)
    model_g = dn.DannCNN(n_domains=3, device=dev)
    st_g = st_c._replace(params=on(st_c.params, dev),
                         batch_stats=on(st_c.batch_stats, dev),
                         opt_state=dn.SgdState(on(st_c.opt_state.trace, dev)))
    xb = rng.random((DANN_BATCH, 63, 63, 3)).astype(np.float32)
    yb, db = labels[:DANN_BATCH], domains[:DANN_BATCH]
    model_64 = dn.DannCNN(n_domains=3, device=cpu).double()
    st_64 = st_c._replace(
        params={k: v.double() for k, v in st_c.params.items()},
        batch_stats={k: v.double() for k, v in st_c.batch_stats.items()})
    errs = {}
    with _patched(dn, dropout=lambda x, *a, **k: x):
        for name, ph in (("mitosis", dn.PHASE_MITOSIS),
                         ("domain", dn.PHASE_DOMAIN),
                         ("adversarial", dn.PHASE_ADVERSARIAL)):
            w = dn.loss_and_grads(model_64, st_64, xb, yb, db, *ph)
            for where, (mod, state) in (("card", (model_g, st_g)),
                                        ("cpu", (model_c, st_c))):
                a = dn.loss_and_grads(mod, state, xb, yb, db, *ph)
                e = (abs(float(a[0]) / float(w[0]) - 1),
                     _rel_leaf(a[3], w[3]), _rel_leaf(a[4], w[4]))
                errs[f"{name} {where}"] = e
                assert e[0] <= 1e-4 and e[1] <= 2e-3 and e[2] <= 1e-4, (
                    name, where, e)
    X = torch.from_numpy(patches).to(dev)
    Y = torch.from_numpy(labels).to(dev)
    D = torch.from_numpy(domains).to(dev)
    step = dn.make_train_step(model_g, tx_d)
    phases = (dn.PHASE_MITOSIS, dn.PHASE_DOMAIN, dn.PHASE_ADVERSARIAL)

    def dann_iter(state, i):
        for j, ph in enumerate(phases):
            s = ((3 * i + j) * DANN_BATCH) % (n_dann - DANN_BATCH)
            state, m = step(state, X[s:s + DANN_BATCH], Y[s:s + DANN_BATCH],
                            D[s:s + DANN_BATCH], *ph)
        return state, m

    st = st_g
    for i in range(3):
        st, _ = dann_iter(st, i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    e = _events()
    e[0].record()
    for i in range(DANN_ITERS):
        st, m = dann_iter(st, i)
    e[1].record()
    torch.cuda.synchronize()
    dann_ms = e[0].elapsed_time(e[1]) / DANN_ITERS
    dann_peak = _peak_text(base)
    assert np.isfinite(float(m["loss"]))
    log(59, "DannCNN (63^2, 3 domains), the card and the CPU each "
            "against the CPU's float64 on the same weights, dropout off: "
            + "; ".join(
                f"{k} loss {v[0]:.1e}, gradients {v[1]:.1e}, statistics "
                f"{v[2]:.1e}" for k, v in errs.items())
            + f" (relative); the three-phase iteration at batch "
              f"{DANN_BATCH}, dropout on: {dann_ms:.3f} ms = "
              f"{3 * DANN_BATCH * 1e3 / dann_ms:.1f} imgs/s over "
              f"{DANN_ITERS} iterations (CUDA events); {dann_peak}; card "
              f"'{smi}'")
    dann_model, dann_state = model_g, st

    # 60. MobileNetDann at the TCGA capacity: 224^2, batch 64, Adam 1e-3,
    # the three phases per iteration (scripts/train_dann_capacity.py's
    # throughput mode); timed, then one iteration traced.
    gen = torch.Generator(device=dev).manual_seed(SEED)
    mnet = bb.MobileNetDann(n_domains=2, alpha=0.5, device=dev,
                            generator=gen)
    trunk = bb.trunk_size(mnet.MobileNetBackbone_0)
    assert trunk == MOBILENET_TRUNK, trunk
    n_mnet = sum(p.numel() for p in mnet.parameters())
    adam = tf.adam(lambda count: 1e-3)
    mst = dn.model_state(mnet, SEED, adam)
    mstep = dn.make_train_step(mnet, adam)
    Xm, ym, dm = synthetic.two_domain_task(4 * MOBILENET_BATCH, seed=SEED,
                                           size=MOBILENET_SIDE,
                                           correlation=0.5)
    Xm, ym, dm = (torch.from_numpy(a).to(dev) for a in (Xm, ym, dm))

    def m_iter(state, i):
        s = (i % 4) * MOBILENET_BATCH
        for ph in phases:
            state, m = mstep(state, Xm[s:s + MOBILENET_BATCH],
                             ym[s:s + MOBILENET_BATCH],
                             dm[s:s + MOBILENET_BATCH], *ph)
        return state, m

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    mst, m = m_iter(mst, 0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    e = _events()
    e[0].record()
    losses = []
    for i in range(MOBILENET_ITERS):
        mst, m = m_iter(mst, i + 1)
        losses.append(m["loss_mit"])
    e[1].record()
    torch.cuda.synchronize()
    mnet_ms = e[0].elapsed_time(e[1]) / MOBILENET_ITERS
    mnet_peak = _peak_text(base)
    assert all(np.isfinite(float(v)) for v in losses)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mst, _ = m_iter(mst, 0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    acts = trace_activities(prof)
    busy = sum(t for _, t in acts.values())
    top = sorted(acts.items(), key=lambda kv: -kv[1][1])[:4]
    imgs_s = 3 * MOBILENET_BATCH * 1e3 / mnet_ms
    log(60, f"MobileNetDann alpha 0.5: trunk {trunk:,} (parameters + "
            f"BatchNorm statistics, keras's), {n_mnet:,} parameters; "
            f"{MOBILENET_SIDE}^2, batch {MOBILENET_BATCH}, Adam, three "
            f"phases per iteration: first iteration {first_s:.2f} s, then "
            f"{mnet_ms:.1f} ms per iteration = {imgs_s:.1f} imgs/s over "
            f"{MOBILENET_ITERS} (CUDA events); {mnet_peak}; task loss "
            f"{float(losses[0]):.4f} -> {float(losses[-1]):.4f}; card "
            f"'{smi}'")
    log(60, f"one traced iteration: {wall_ms:.1f} ms on the host clock, "
            f"device busy {busy:.1f} ms, idle {1 - busy / wall_ms:.2%}; top "
            f"device activities: " + "; ".join(
                f"{k[:60]} x{n} {t:.1f} ms ({t / busy:.1%})"
                for k, (n, t) in top))
    del mnet, mst, Xm, ym, dm, prof

    # 61. The six CLIs as subprocesses, started together, at small step
    # counts; the probe and the seg demo's --capacity-ckpt on phase 49's
    # card checkpoint and on phase 57's CPU-saved one.
    root = Path(__file__).resolve().parent

    def cli(name, *args):
        return [sys.executable, str(root / "scripts" / f"torch_{name}.py"),
                *map(str, args), "--device", dev.type]

    seg_small = ["--size", 64, "--train-tiles", 32, "--eval-tiles", 8,
                 "--batch", 16]
    cap = ["--methods", "flow", "--seg-steps", 10, "--class-match",
           "--class-match-scope", "center", "--transfer", "quantile"]
    probe = ["--size", 64, "--tiles", 8, "--batch", 8, "--template-tiles", 16]
    pil = _has_pil()
    cmds = {
        "seg": cli("seg_transfer_demo", *seg_small, "--seg-steps", 30,
                   "--flow-steps", 10, "--flow-hidden", 16,
                   "--flow-blocks", 1, "--methods",
                   "raw,macenko,vahadane,reinhard,flow", "--out",
                   work / "seg", *(["--seg-augment"] if pil else [])),
        "seg_cap": cli("seg_transfer_demo", *seg_small, *cap,
                       "--capacity-ckpt", work / "capacity_ckpt", "--out",
                       work / "seg_cap"),
        "seg_cap_cpu": cli("seg_transfer_demo", *seg_small, *cap,
                           "--capacity-ckpt", work / "capacity_ckpt_cpu",
                           "--out", work / "seg_cap_cpu"),
        "effect": cli("flow_effect_demo", "--steps", 20, "--image-size", 32,
                      "--batch", 16, "--tiles-per-center", 8, "--hidden", 16,
                      "--blocks", 1, "--out", work / "effect"),
        "probe": cli("flow_transfer_probe", *probe, "--ckpt",
                     work / "capacity_ckpt", "--out", work / "probe"),
        "probe_cpu": cli("flow_transfer_probe", *probe, "--ckpt",
                         work / "capacity_ckpt_cpu", "--out",
                         work / "probe_cpu"),
        "dann": cli("train_dann", "--reps", 1, "--epochs", 1, "--iters", 20,
                    "--warmup", 5, "--augment", "hed", "--out",
                    work / "dann"),
        "invariance": cli("dann_invariance_demo", "--iters", 20, "--reps", 1,
                          "--n-train", 256, "--n-test", 128, "--out",
                          work / "invariance"),
        "capacity": cli("train_dann_capacity", *CAPACITY_CLI),
        "capacity_inv": cli("train_dann_capacity", "--invariance", "--size",
                            64, "--iters", 5, "--reps", 1, "--n-train", 128),
        "capacity_short": cli("train_dann_capacity", "--shortcut",
                              "--domain-cue", "stain", "--size", 64,
                              "--iters", 5, "--reps", 1, "--n-train", 128),
    }
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, cwd=root)
             for k, c in cmds.items()}
    outs = {}
    try:
        for k, p in procs.items():
            out, err = p.communicate(timeout=400)
            outs[k] = out
            assert p.returncode == 0, (k, out[-2000:] + err[-3000:])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    cli_s = time.perf_counter() - t0
    res = {k: json.loads(v.strip().splitlines()[-1]) for k, v in outs.items()
           if k not in ("dann",)}
    assert set(res["seg"]["conditions"]) == {
        "raw", "macenko", "vahadane", "reinhard", "flow"}
    for k in ("seg_cap", "seg_cap_cpu"):
        assert "capacity flow checkpoint: step 10, EMA" in outs[k], k
    for c, a in res["probe"].items():
        b = res["probe_cpu"][c]
        assert a["class_usage"] == b["class_usage"], (c, a, b)
        assert abs(a["bpd"] - b["bpd"]) <= 1e-3 * abs(a["bpd"]), (c, a, b)
    assert res["capacity"]["trunk_params_plus_stats"] == MOBILENET_TRUNK
    assert "mean [auc_int f1_int auc_ext f1_ext]:" in outs["dann"]
    log(61, f"the six CLIs, {len(cmds)} processes started together, all "
            f"exit 0 in {cli_s:.1f} s: seg demo shifted mIoU "
            + ", ".join(f"{k} {v['shifted_mean_miou']}"
                        for k, v in res["seg"]["conditions"].items())
            + (" (--seg-augment)" if pil else "")
            + f"; --capacity-ckpt from the card's checkpoint "
              f"{res['seg_cap']['conditions']['flow']['per_center']} and "
              f"from the CPU-saved one "
              f"{res['seg_cap_cpu']['conditions']['flow']['per_center']}; "
              f"probe: both checkpoints give the same class usage, bpd "
              f"{res['probe']['center0']['bpd']} / "
              f"{res['probe_cpu']['center0']['bpd']} (center 0); effect "
              f"demo NMI sd {res['effect']['raw_nmi_sd']} -> "
              f"{res['effect']['normalized_nmi_sd']}; invariance "
              f"{json.dumps(res['invariance']['probe_dann'])}; capacity "
              f"{res['capacity']['imgs_per_s']} imgs/s (host clock, 5 "
              f"iterations, 224^2, batch 64), invariance "
              f"{json.dumps(res['capacity_inv'])}, shortcut (stain cue) "
              f"{json.dumps(res['capacity_short'])}; card '{smi}'")
    if not pil:
        log(61, "PIL is not on this host: --seg-augment (JPEG "
                "recompression) is not run here; the CPU tests run it")

    # 62. The generators with a card model: phase 59's DannCNN scores every
    # 63^2 window of a 1024^2 field at stride 32, against the CPU model of
    # the same weights on its first 255 rows (atol 1e-4); hard negatives.
    field = tiles(1, 1024, SEED + 62)[0]
    cpu_state = dann_state._replace(
        params=on(dann_state.params, cpu),
        batch_stats=on(dann_state.batch_stats, cpu))

    def card_fn(b):
        return dn.predict_mitosis(dann_model, dann_state, b)

    def cpu_fn(b):
        return dn.predict_mitosis(model_c, cpu_state, b)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    heat = generators.sliding_window_scores(card_fn, field, 63, 32, 256)
    heat_s = time.perf_counter() - t0
    crop = generators.sliding_window_scores(cpu_fn, field[:255], 63, 32, 256)
    heat_err = float(np.abs(heat[:crop.shape[0]] - crop).max())
    assert heat.shape == (31, 31) and np.isfinite(heat).all()
    assert heat_err <= 1e-4, heat_err
    win = generators.extract_patches(field, 63, 32)
    idx, scores = generators.mine_hard_negatives(
        card_fn, win, np.zeros(len(win), np.int64), 16, 256)
    assert len(idx) == 16 and (np.diff(scores) <= 0).all()
    if _has_pil():
        generators.save_heatmap(str(work / "heatmap.png"), heat)
        assert (work / "heatmap.png").exists()
        heat_msg = "save_heatmap wrote its PNG"
    else:
        heat_msg = ("PIL is not on this host: save_heatmap is not run here "
                    "(the CPU tests hold it)")
    log(62, f"sliding_window_scores, phase 59's DannCNN on the card: a "
            f"1024^2 field, 63^2 windows at stride 32 -> {heat.shape} in "
            f"{heat_s * 1e3:.1f} ms (host clock, {len(win)} windows), the "
            f"CPU model of the same weights on the first 255 rows max "
            f"|diff| {heat_err:.2e}; mine_hard_negatives top 16 of "
            f"{len(win)} (scores {scores[0]:.4f} .. {scores[-1]:.4f}); "
            f"{heat_msg}")
    log(62, f"phases 57-62 took {time.perf_counter() - t_phases:.1f} s")


# ---- The last modules: utils, data CLIs, scale, examples (phases 63-68) ----
# Phase 66 drives normalize_slide past the RAM-canvas threshold (K3 once per
# batch of 128); phase 67 runs the demo's panels (K1, K2, K5, K7 through the
# drop-in API) and the notebook's cells (K1, K3, K5, K7).
SCALE_SIDE = 20480  # 1.17 GiB of level 0, 6,400 tiles of 256^2: a memmap
SCALE_BATCH = 128
INGEST = ("--container", "wsiraw", "--size", 8192, "--n", 256)
# Demo panels, card against CPU (PERF.md section 2): index -> (kind, max u8)
DEMO_PANELS = {0: ("equal", 0), 1: ("augmenter", 255), 2: ("augmenter", 255),
               3: ("pop", 255), 4: ("normalizer", 2), 5: ("pop", 255),
               6: ("normalizer", 4), 7: ("normalizer", 3),
               8: ("augmenter", 255), 9: ("augmenter", 255),
               10: ("augmenter", 255)}


def _load_path(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rest_phases(dev, smi, work: Path, big: str) -> dict:
    """Phases 63-68: ``utils`` and ``config`` (63); the data CLIs:
    ``torch_convert_wsi.py`` on the 16,384^2 slide of phase 41 (64) and
    ``torch_bench_host_ingestion.py`` on WSIRAW (65); the reference-scale
    drive ``torch_bench_wsi_scale.py`` at 20,480^2, its canvas a memmap, K3
    once per batch (66); the augmentation demo's panels on the card against
    the CPU and the walkthrough notebook's cells on the card (67); and
    ``torch_launch_multihost.sh`` through torchrun at world 1 (68).
    Returns the launches of phase 66 (``K3_scale``) and of the examples
    (``<route>_example``)."""
    from stainlib_tpu_torch import config
    from stainlib_tpu_torch.data import native
    from stainlib_tpu_torch.data.preprocessing import build_pyramid
    from stainlib_tpu_torch.kernels import macenko_fused as mf
    from stainlib_tpu_torch.kernels import reinhard_fused as rf
    from stainlib_tpu_torch.kernels import vahadane_fused as vf
    from stainlib_tpu_torch.models import train_flow as tf
    from stainlib_tpu_torch.normalization import extractive
    from stainlib_tpu_torch.normalization import slide as sl
    from stainlib_tpu_torch.utils import checkpoint as ck
    from stainlib_tpu_torch.utils import profiling
    from stainlib_tpu_torch.utils.watchdog import StallWatchdog

    root = Path(__file__).resolve().parent
    t_phases = time.perf_counter()

    def counts():
        return dict(K1=mf.launches, K2=vf.launches, K3=mf.matrix_launches,
                    K5=rf.launches, K7=mf.augment_launches)

    def reset():
        mf.launches = vf.launches = mf.matrix_launches = rf.launches = 0
        mf.augment_launches = 0

    # 63. utils and config on the card.
    events = []
    with StallWatchdog(timeout_s=0.3, poll_s=0.02,
                       on_stall=events.append) as wd:
        for _ in range(10):
            wd.beat()
            time.sleep(0.03)
        quiet = wd.stall_count
        time.sleep(0.6)
    assert quiet == 0 and wd.stall_count == 1 and len(events) == 1, (
        quiet, wd.stall_count, events)
    batch = torch.from_numpy(tiles(64, SIDE, SEED + 63)).to(dev)
    p = extractive.fit(torch.from_numpy(tiles(1, SIDE, SEED + 64)[0]).to(dev))
    planar = mf.to_planar(batch).contiguous()

    def k1():
        return mf.macenko_normalize(batch, p.stain_matrix_target,
                                    p.max_c_target, **FAST)

    def k1_plain():
        return mf.macenko_normalize_planar_ref(
            planar, p.stain_matrix_target, p.max_c_target, **FAST)

    (ka, kb), (pa, pb) = time_pair(k1, k1_plain)
    # Each step's host-clock time covers its own CUDA-event time (the
    # clock starts before the start event and stops after a synchronize
    # that follows the end event); the p50 is reported beside time_pair's
    # event time, a separate sample (they differ by some percent).
    timer, step_ev = profiling.StepTimer(), []
    for _ in range(REPS):
        with timer.measure() as out:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out["result"] = {"tiles": k1(), "host": [np.zeros(1), None]}
            end.record()
        step_ev.append(start.elapsed_time(end))
    p50_ms = timer.p50() * 1e3
    assert all(t * 1e3 >= e for t, e in zip(timer.times, step_ev)), (
        timer.times, step_ev)
    # trace + annotate late in this long process: the region and all three
    # K1 kernels must be there. trace's warm-up step takes the records the
    # profiler drops after unprofiled time; where a launch still lost its
    # kernel, trace raises and keeps nothing, and the block is traced again
    # (at most three times, each refusal logged).
    trace_dir = work / "trace63"
    refused = []
    while True:
        before = mf.launches
        try:
            with profiling.trace(str(trace_dir)):
                with profiling.annotate("chip_smoke_k1_region"):
                    for _ in range(3):
                        k1()
            break
        except RuntimeError as err:
            refused.append(str(err))
            log(63, f"trace refused: {err}")
            if len(refused) == 3:
                raise
    assert mf.launches == before + 3, (before, mf.launches)
    traces = sorted(trace_dir.glob("trace_*.json"))
    assert len(traces) == 1, traces
    trace_events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "chip_smoke_k1_region" for e in trace_events)
    n_k1 = sum(e.get("cat") == "kernel"
               and "macenko_apply_kernel" in e.get("name", "")
               for e in trace_events)
    assert n_k1 == 3 or dev.type != "cuda", n_k1
    cfg = config.Config()
    assert cfg.flow.image_size == 32 and cfg.sampler.tile == 256
    log(63, f"StallWatchdog: quiet under 10 beats 30 ms apart, one firing "
            f"after {events[0]:.3f} s at a 0.3 s timeout; StepTimer around "
            f"K1 (B=64 {SIDE}^2, host clock, a synchronize per step): p50 "
            f"{p50_ms:.4f} ms, each of {REPS} steps at or above its own "
            f"CUDA-event time (median {float(np.median(step_ev)):.4f} ms); "
            f"time_pair: K1 {ka:.4f}, {kb:.4f} ms, plain {pa:.4f}, "
            f"{pb:.4f} ms; trace + annotate around three K1 calls (3 "
            f"launches counted): {traces[0].name}, "
            f"{traces[0].stat().st_size:,} bytes, holds the region and "
            f"{n_k1} macenko_apply_kernel events, no launch without its "
            f"kernel ({len(refused)} lossy traces refused before it); "
            f"Config() builds; card '{smi}'")

    # 64. The converter, a subprocess, WSIRAW -> WSIRAW with levels
    # synthesized down to 512.
    conv = work / "converted.wsiraw"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "scripts/torch_convert_wsi.py", big,
                        str(conv), "--min-dim", "512"], capture_output=True,
                       text=True, timeout=300, cwd=root)
    conv_s = time.perf_counter() - t0
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    s_in, s_out = native.open_slide(big), native.open_slide(str(conv))
    want = [s_in.read_region(i, 0, 0, *s_in.level_size(i))
            for i in range(s_in.num_levels)]
    while min(want[-1].shape[:2]) >= 2 * 512:
        want.append(build_pyramid(want[-1], 2)[1])
    assert s_out.num_levels == len(want), (s_out.num_levels, len(want))
    for i, w in enumerate(want):
        got = s_out.read_region(i, 0, 0, *s_out.level_size(i))
        assert np.array_equal(got, w), f"converted level {i} differs"
    s_in.close(), s_out.close()
    sizes = [f"{w.shape[1]}x{w.shape[0]}" for w in want]
    del want, got
    conv.unlink()
    log(64, f"scripts/torch_convert_wsi.py {SLIDE_SIDE:,}^2 WSIRAW -> WSIRAW "
            f"--min-dim 512 in {conv_s:.2f} s (a subprocess, start-up "
            f"included): levels {sizes}, each equal byte for byte to the "
            f"source's level or build_pyramid's")

    # 65. Host decode rates of the WSIRAW reader (no libtiff here).
    r = subprocess.run([sys.executable, "scripts/torch_bench_host_ingestion.py",
                        *map(str, INGEST)], capture_output=True, text=True,
                       timeout=300, cwd=root)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    ingest = json.loads(r.stdout.strip().splitlines()[-1])
    assert ingest["container"] == "wsiraw" and len(ingest["by_threads"]) == 1
    log(65, f"scripts/torch_bench_host_ingestion.py "
            f"{' '.join(map(str, INGEST))}: {json.dumps(ingest)} (train path "
            f"RawSlide.sample_tiles, eval path one read_region per tile; "
            f"tiles/s on this host's {ingest['host_cores']} cores)")

    # 66. The reference-scale drive: level 0 above the 1 GiB RAM-canvas
    # threshold, so the canvas and the pyramid are disk memmaps.
    scale = _load_path(root / "scripts" / "torch_bench_wsi_scale.py",
                       "torch_bench_wsi_scale")
    args = scale.parse_args([
        "--container", "wsiraw", "--no-write", "--side", str(SCALE_SIDE),
        "--batch", str(SCALE_BATCH), "--workdir", str(work / "scale"),
        "--keep", "--device", dev.type])
    reset()
    summary, canvas = scale.drive(args)
    torch.cuda.synchronize()
    c66 = counts()
    n_scale = (SCALE_SIDE // SIDE) ** 2
    want_k3 = -(-n_scale // SCALE_BATCH)
    assert summary["canvas"] == "memmap", summary
    assert summary["tiles"] == n_scale and summary["fused"] is True, summary
    assert summary["out_gb"] is None and summary["parts_s"]["write"] is None
    assert c66 == dict(K1=0, K2=0, K3=want_k3, K5=0, K7=0), c66
    src = str(work / "scale" / "scale_in.wsiraw")
    slide_p = sl.fit_slide(src, device=dev)
    tp = extractive.fit(torch.from_numpy(scale._target()).to(dev))
    coords = sl._grid_coords(SCALE_SIDE, SCALE_SIDE, SIDE)
    pick = np.random.default_rng(SEED + 66).choice(len(coords), 64,
                                                   replace=False)
    s = native.open_slide(src)
    tl = torch.from_numpy(np.stack([s.read_region(0, *coords[i], SIDE, SIDE)
                                    for i in pick])).to(dev)
    s.close()
    plain = mf.normalize_with_matrix_ref(tl, slide_p.stain_matrix,
                                         slide_p.max_c, *tp).cpu().numpy()
    func = extractive.transform_with_matrix(
        tl, slide_p.stain_matrix, slide_p.max_c, tp).cpu().numpy()
    got = np.stack([canvas[coords[i][1]:coords[i][1] + SIDE,
                           coords[i][0]:coords[i][0] + SIDE] for i in pick])
    assert np.array_equal(got, plain), "K3 on the scale slide differs"
    d = np.abs(got.astype(np.int16) - func)
    mx66, over66 = int(d.max()), float((d > 1).mean())
    assert mx66 <= 3 and over66 < 5e-3, (mx66, over66)
    del canvas, got, tl
    (work / "scale" / "scale_in.wsiraw").unlink()
    log(66, f"scripts/torch_bench_wsi_scale.py --container wsiraw --no-write "
            f"--side {SCALE_SIDE} --batch {SCALE_BATCH} (in this process): "
            f"{json.dumps(summary)}; K3 launches {c66['K3']} (= ceil("
            f"{n_scale}/{SCALE_BATCH})), no other kernel; 64 canvas tiles "
            f"drawn from a seed equal byte for byte to "
            f"normalize_with_matrix_ref on the same tiles, vs the functional "
            f"path max={mx66} u8, share>1={over66:.3e} (gate: max<=3, "
            f"share>1<5e-3); the peak RSS is this process's, earlier phases "
            f"included; card '{smi}'")

    # 67. The examples: the demo's panels on the card against the CPU, then
    # the notebook's code cells on the card.
    demo = _load_path(root / "examples" / "torch_augmentation_demo.py",
                      "torch_augmentation_demo")
    reset()
    card, titles = demo.build_panels(dev.type, 1)
    torch.cuda.synchronize()
    c_demo = counts()
    assert c_demo == dict(K1=1, K2=1, K3=0, K5=1, K7=2), c_demo
    cpu, _ = demo.build_panels("cpu", 1)
    again, _ = demo.build_panels(dev.type, 1)
    gaps = []
    for i, (kind, mx) in DEMO_PANELS.items():
        assert card[i].dtype == np.uint8 and card[i].shape == (224, 224, 3)
        d = np.abs(card[i].astype(np.int16) - cpu[i])
        if kind == "equal":
            assert d.max() == 0, titles[i]
        elif kind == "pop":
            assert np.percentile(d, 99) <= 4, titles[i]
        else:
            assert d.max() <= mx and (d > 1).mean() < 1e-2, (
                titles[i], int(d.max()), float((d > 1).mean()))
        assert np.array_equal(card[i], again[i]), (titles[i], "runs differ")
        gaps.append(f"{titles[i]} {int(d.max())}/{float((d > 1).mean()):.1e}")
    log(67, f"build_panels('{dev.type}', 1) vs build_panels('cpu', 1), 11 panels "
            f"of 224^2: max u8 / share>1 per panel: {'; '.join(gaps)} "
            f"(gates: normalizers max K1 2, K2 4, K5 3 and share>1<1e-2; "
            f"augmenters share>1<1e-2; pops 99th pct<=4); two card runs "
            f"identical; launches {c_demo}")
    import tempfile

    from stainlib_tpu_torch.utils import plot

    nb = json.loads((root / "examples"
                     / "stainlib_tpu_torch_walkthrough.ipynb").read_text())
    cells = ["".join(c["source"]) for c in nb["cells"]
             if c["cell_type"] == "code"]
    assert cells[0].startswith('DEVICE = "cuda"')
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    real_plot, real_tmp = plot.plot_image_grid, tempfile.tempdir
    if has_mpl:
        import matplotlib

        matplotlib.use("Agg")
    else:  # the cells' figures are not drawn; everything else runs
        plot.plot_image_grid = lambda *a, **k: None
    (work / "notebook").mkdir()
    tempfile.tempdir = str(work / "notebook")
    reset()
    ns = {}
    t0 = time.perf_counter()
    try:
        for src in cells:
            src = src.replace('DEVICE = "cuda"', f'DEVICE = "{dev.type}"')
            exec(compile(src, "stainlib_tpu_torch_walkthrough.ipynb",
                         "exec"), ns)
        torch.cuda.synchronize()
    finally:
        plot.plot_image_grid, tempfile.tempdir = real_plot, real_tmp
        if has_mpl:
            import matplotlib.pyplot as plt

            plt.close("all")
    nb_s = time.perf_counter() - t0
    c_nb = counts()
    assert ns["normalized_batch"].device.type == dev.type
    assert ns["out_lv0"].shape == (512, 512, 3)
    assert c_nb["K1"] >= 2 and c_nb["K5"] == 1 and c_nb["K7"] == 2, c_nb
    assert c_nb["K3"] == 1, c_nb  # the slide cell: one batch of 4 tiles
    example = {k: c_demo[k] + c_nb[k] for k in c_demo}
    log(67, f"the notebook's {len(cells)} code cells on the card with "
            f"DEVICE = 'cuda' in {nb_s:.2f} s: launches {c_nb}; "
            + ("matplotlib drew the figures" if has_mpl else
               "matplotlib is not on this host: plot_image_grid is not run "
               "here (the CPU tests run it)")
            + ("" if native.tiff_native_available() else
               "; this host has no libtiff: the whole-slide cell does not "
               "write the TIFF and runs the slide's tiles through K3 "
               "directly"))

    # 68. The launcher: torchrun, NCCL at world 1, two steps, a checkpoint
    # that the port restores. Beside it, phase 63's card test in a fresh
    # process: its trace of K1 must hold the region and the kernel.
    env = dict(os.environ, GPUS_PER_HOST="1", STEPS="2",
               PYTHON=sys.executable)
    save = work / "launch_ckpt"
    cmds = {"launch": (["bash", "scripts/torch_launch_multihost.sh",
                        "--image-size", "32", "--batch", "8", "--device",
                        dev.type, "--save", str(save)], env),
            "utils": ([sys.executable, "-m", "pytest", "--noconftest", "-q",
                       "-m", "cuda", "-p", "no:cacheprovider",
                       "tests/test_torch_utils_cuda.py"], None)}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, cwd=root,
                                 env=e) for k, (c, e) in cmds.items()}
    outs, secs = {}, {}
    try:
        for k, p in procs.items():
            out, err = p.communicate(timeout=300)
            secs[k] = time.perf_counter() - t0
            outs[k] = out + err
            assert p.returncode == 0, (k, out[-3000:] + err[-3000:])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    launch_s = secs["launch"]
    summary = [ln for ln in outs["utils"].splitlines()
               if " passed" in ln or " skipped" in ln][-1]
    assert dev.type != "cuda" or "3 passed" in summary, summary
    log(63, f"tests/test_torch_utils_cuda.py in a fresh process (beside "
            f"the launcher, {secs['utils']:.1f} s; its trace of K1 holds "
            f"the region and macenko_apply_kernel): {summary.strip()}")
    text = outs["launch"]
    assert f"device {dev.type}" in text and "world 1" in text, text[-2000:]
    _, _, template, _ = tf.init_flow_state(tf.FlowConfig(image_size=32), 0,
                                           device=dev)
    restored = ck.restore_checkpoint(str(save), template)
    assert restored.step == 2
    assert all(bool(torch.isfinite(v).all())
               for v in restored.params["flow"].values())
    log(68, f"GPUS_PER_HOST=1 STEPS=2 scripts/torch_launch_multihost.sh "
            f"--image-size 32 --batch 8 --device cuda: torchrun, NCCL at "
            f"world 1, exit 0 in {launch_s:.1f} s; its checkpoint restores "
            f"into a card template at step 2, finite")
    log(68, f"phases 63-68 took {time.perf_counter() - t_phases:.1f} s")
    launches = {"K3_scale": c66["K3"]}
    launches.update({f"{k}_example": v for k, v in example.items() if v})
    return launches


PROBE_FAMILIES = (None, "vahadane-roofline")  # the default grid, then --only


def command_phases(dev, smi) -> None:
    """Phases 69-71, the user-facing chip commands in this process:
    ``scripts/torch_validate_gpu.py`` at its default size and with
    ``--full`` (69), ``scripts/torch_probe_kernels.py``'s default grid and
    its ``vahadane-roofline`` family (70), and
    ``torch_dryrun_multichip.entry()``'s ``fn`` on the card against the same
    call on the CPU (71)."""
    import io

    from stainlib_tpu_torch.kernels import fused_stain as fs
    from stainlib_tpu_torch.kernels import macenko_fused as mf
    from stainlib_tpu_torch.kernels import reinhard_fused as rf
    from stainlib_tpu_torch.kernels import vahadane_fused as vf

    root = Path(__file__).resolve().parent
    counters = dict(K1=(mf, "launches"), K2=(vf, "launches"),
                    K3=(mf, "matrix_launches"), K4=(mf, "fit_launches"),
                    K5=(rf, "launches"), K6=(mf, "aug_launches"),
                    K7=(mf, "augment_launches"), K8=(vf, "dict_launches"),
                    K9=(fs, "launches"), K10=(mf, "eigenplane_launches"))

    def counted(fn):
        """``fn()``'s result and the launches of each kernel it made."""
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        out = fn()
        torch.cuda.synchronize()
        return out, {k: getattr(mod, attr)
                     for k, (mod, attr) in counters.items()
                     if getattr(mod, attr)}

    # 69. The validation command, its stdout captured and checked.
    vg = _load_path(root / "scripts" / "torch_validate_gpu.py",
                    "torch_validate_gpu")
    for argv in ([], ["--full"]):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc, n69 = counted(lambda: vg.main([*argv, "--device", dev.type]))
        secs = time.perf_counter() - t0
        lines = buf.getvalue().strip().splitlines()
        assert rc == 0 and lines[-1] == "VALIDATE-GPU-OK", lines[-3:]
        results = [ln for ln in lines if ln.startswith("RESULT ")]
        assert len(results) == 6, results
        for ln in results[:-1]:
            mx = int(ln.split("max diff ")[1].split(",")[0])
            assert mx <= 4 and float(ln.split("frac>1 ")[1]) < 1e-2, ln
        assert results[-1].endswith("max diff 0"), results[-1]
        assert dev.type != "cuda" or set(n69) == {"K1", "K2", "K5", "K7",
                                                  "K8"}, n69
        for ln in lines:
            if ln.startswith(("RESULT ", "THROUGHPUT ")):
                log(69, ln)
        log(69, f"scripts/torch_validate_gpu.py {' '.join(argv)} in "
                f"{secs:.1f} s: last line {lines[-1]}; launches {n69}; card "
                f"'{smi}'")

    # 70. The probe grid: every entry a finite rate and a fidelity.
    pk = _load_path(root / "scripts" / "torch_probe_kernels.py",
                    "torch_probe_kernels")
    out_dir = root / ".runs"
    for only in PROBE_FAMILIES:
        argv = ["--only", only] if only else []
        path = out_dir / f"probe_{only or 'default'}.json"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res, n70 = counted(lambda: pk.run(pk.parse_args(
                [*argv, "--out", str(path), "--device", dev.type])))
        secs = time.perf_counter() - t0
        assert res["device"] == torch.cuda.get_device_name(dev)
        assert list(res["entries"]) == [e[0] for e in pk.grid(only)]
        for name, e in res["entries"].items():
            assert np.isfinite(e["tiles_per_s"]) and e["tiles_per_s"] > 0, (
                name, e)
            assert e["max_diff"] >= 0 and 0 <= e["frac_gt1"] <= 1, (name, e)
        log(70, f"scripts/torch_probe_kernels.py {' '.join(argv)} in "
                f"{secs:.1f} s ({len(res['entries'])} entries, CUDA-event "
                f"chains of {res['iters']} steps, batch {res['batch']}); "
                f"launches {n70}; card '{smi}':")
        print(json.dumps(res), flush=True)

    # 71. The one-card compile check's entry on the card against the CPU.
    dry = _load_path(root / "scripts" / "torch_dryrun_multichip.py",
                     "torch_dryrun_multichip")
    fn, args = dry.entry()
    assert args[1].device.type == dev.type  # the default: the card
    assert args[0].stain_matrix_target.device.type == dev.type
    got, n71 = counted(lambda: fn(*args))
    fn_cpu, args_cpu = dry.entry(device="cpu")
    want = fn_cpu(*args_cpu)
    assert got.dtype == torch.uint8 and got.shape == want.shape == (4, 64,
                                                                   64, 3)
    mx, share, _ = compare(got.cpu(), want)
    assert mx <= 1 and share < 1e-3, (mx, share)
    log(71, f"torch_dryrun_multichip.entry(): fn(params, batch), the "
            f"functional Macenko transform of 4 tiles of 64^2, on the card "
            f"vs device='cpu': max={mx} u8, share differing={share:.3e} "
            f"(gate: max<=1, share<1e-3); launches {n71 or 'none'}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to PyTorch", file=sys.stderr)
        return 2

    return run(torch.device("cuda", 0))


def run(dev) -> int:
    import stainlib_tpu_torch as st
    from stainlib_tpu_torch.extraction.vahadane import stain_matrix_vahadane
    from stainlib_tpu_torch.kernels import _build
    from stainlib_tpu_torch.kernels import fused_stain as fs
    from stainlib_tpu_torch.kernels import macenko_fused as mf
    from stainlib_tpu_torch.kernels import reinhard_fused as rf
    from stainlib_tpu_torch.kernels import vahadane_fused as vf
    from stainlib_tpu_torch.normalization import extractive, reinhard

    assert "jax" not in sys.modules, "the port imported jax"
    t_run = time.perf_counter()

    # 1. Environment.
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log(1, f"device={name!r} count={torch.cuda.device_count()} "
           f"nvidia-smi='{smi}' torch={torch.__version__} "
           f"cuda={torch.version.cuda} python={sys.version.split()[0]}")

    # 2. Build the kernel library from the checkout's sources.
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log(2, f"built={_build.build_info['built']} nvcc_s="
           f"{_build.build_info['seconds']:.2f} load_s={build_s:.2f} "
           f"ptxas: {ptxas_summary(_build.build_info.get('log', ''))}")

    target = tiles(1, SIDE, SEED)[0]
    batch_np = tiles(B, SIDE, SEED + 1)
    batch = torch.from_numpy(batch_np).to(dev)
    planar = mf.to_planar(batch).contiguous()
    big512 = torch.from_numpy(tiles(B_LARGE, SIDE_LARGE, SEED + 7)).to(dev)
    kernels = []

    # ---- Macenko (K1) -----------------------------------------------------
    # The main path, counted: the drop-in class on one 256^2 image, then the
    # batched entry on B tiles. Nothing else may launch between the reset
    # and the read.
    mf.launches = 0
    norm = st.ExtractiveStainNormalizer("macenko", device=dev)
    norm.fit(target)
    single = norm.transform(batch_np[0])
    params = extractive.ExtractiveParams(
        torch.from_numpy(norm.stain_matrix_target).to(dev),
        torch.from_numpy(norm.maxC_target[0]).to(dev))
    out = mf.macenko_normalize(batch, params.stain_matrix_target,
                               params.max_c_target, **FAST)
    torch.cuda.synchronize()
    launches = mf.launches

    # 3. Drop-in path.
    assert launches >= 1, "the main path never launched the kernel"
    assert single.dtype == np.uint8 and single.shape == (SIDE, SIDE, 3), (
        single.dtype, single.shape)
    assert np.isfinite(norm.stain_matrix_target).all()
    assert (single == out[0].cpu().numpy()).all(), (
        "drop-in transform differs from the batched kernel on the same tile")
    log(3, f"drop-in fit+transform {SIDE}x{SIDE}: out {single.dtype} "
           f"{single.shape}, stain_matrix_target="
           f"{np.round(norm.stain_matrix_target, 4).tolist()} "
           f"maxC_target={np.round(norm.maxC_target, 4).tolist()}; "
           f"main-path launches={launches}")

    # 4. Batched path: kernel against its plain version, same CUDA tensors.
    ref = mf.macenko_normalize_planar_ref(
        planar, params.stain_matrix_target, params.max_c_target, **FAST)
    ref = mf.from_planar(ref, SIDE, SIDE)
    assert out.shape == batch.shape and out.dtype == torch.uint8
    mx, share, _ = compare(out, ref)
    assert mx <= 1 and share < 1e-3, (mx, share)
    planar_out = mf.macenko_normalize_planar(
        planar, params.stain_matrix_target, params.max_c_target, **FAST)
    assert torch.equal(mf.from_planar(planar_out, SIDE, SIDE), out), (
        "planar and interleaved entries disagree")
    log(4, f"K1 vs plain B={B} {SIDE}^2 fs=2 nb=10: max={mx} u8, "
           f"share differing={share:.3e} (gate: max<=1, share<1e-3); "
           f"planar entry identical")
    max_abs_err = mx

    # 5. Kernel against the port's functional path (validate_tpu.py gate).
    want = extractive.transform(params, batch)
    mac_func_card = want
    mx5, _, over1 = compare(out, want)
    assert mx5 <= 2 and over1 < 1e-2, (mx5, over1)
    log(5, f"K1 vs functional extractive.transform: max={mx5} u8, "
           f"share>1={over1:.3e} (gate: max<=2, share>1<1e-2)")

    # 6. Determinism.
    again = mf.macenko_normalize(batch, params.stain_matrix_target,
                                 params.max_c_target, **FAST)
    assert torch.equal(out, again), "two runs differ"
    log(6, "two K1 runs byte-identical")

    # 7. 512^2 tiles: kernel against plain version.
    got = mf.macenko_normalize(big512, params.stain_matrix_target,
                               params.max_c_target, **FAST)
    ref = mf.macenko_normalize_ref(big512, params.stain_matrix_target,
                                   params.max_c_target, **FAST)
    mx7, share7, _ = compare(got, ref)
    assert mx7 <= 1 and share7 < 1e-3, (mx7, share7)
    max_abs_err = max(max_abs_err, mx7)
    log(7, f"K1 vs plain B={B_LARGE} {SIDE_LARGE}^2 fs=2: max={mx7} u8, "
           f"share differing={share7:.3e}")

    one256 = batch[:1].contiguous()
    k1_shapes = ((f"B={B} {SIDE}^2", batch), (f"B={B_LARGE} {SIDE_LARGE}^2",
                                              big512), (f"B=1 {SIDE}^2", one256))
    for label, x in k1_shapes:
        g1 = mf._launch(x, False, params.stain_matrix_target,
                        params.max_c_target, g=1, **FAST)
        for g in mf.CLUSTER_SIZES[1:]:
            assert torch.equal(mf._launch(
                x, False, params.stain_matrix_target, params.max_c_target,
                g=g, **FAST), g1), (label, g)
        assert torch.equal(mf.macenko_normalize(
            x, params.stain_matrix_target, params.max_c_target, **FAST),
            g1), label
        log(7, f"K1 {label} fs=2: clusters of {list(mf.CLUSTER_SIZES)} blocks "
               f"per tile and the plan's each byte-identical to G=1; "
               f"{plan_text('K1', x.shape[1], 2, x.shape[0])}")
    assert torch.equal(g1[0], out[0]), "K1 on one tile differs from the batch"

    # 8. Timing at the main path's shape, kernel and plain in turns.
    (ka, kb), (pa, pb) = time_pair(
        lambda: mf.macenko_normalize(batch, params.stain_matrix_target,
                                     params.max_c_target, **FAST),
        lambda: mf.macenko_normalize_ref(batch, params.stain_matrix_target,
                                         params.max_c_target, **FAST))
    log(8, f"K1 B={B} {SIDE}^2 fs=2 nb=10, median of {REPS} CUDA-event runs "
           f"(plain, kernel, kernel, plain): kernel {ka:.3f}/{kb:.3f} ms = "
           f"{B / min(ka, kb) * 1e3:.0f} tiles/s; plain {pa:.3f}/{pb:.3f} "
           f"ms = {B / min(pa, pb) * 1e3:.0f} tiles/s; card '{smi}'")
    for label, x in k1_shapes:
        def k1_call(x=x):
            return mf.macenko_normalize(x, params.stain_matrix_target,
                                        params.max_c_target, **FAST)
        log(8, f"K1 {label} fs=2 nb=10: the kernel alone (torch.profiler "
               f"device time per call, {REPS} calls) "
               f"{fmt_ms(device_ms(k1_call, 'macenko_apply_kernel'))}; by "
               f"events {time_ms(k1_call):.4f} ms (median of {REPS}); card "
               f"'{smi}'")
    kernels.append(dict(
        name="macenko_normalize_planar", route="cuda",
        source="stainlib_tpu_torch/kernels/csrc/macenko_fused.cu",
        replaces="stainlib_tpu/kernels/macenko_fused.py:541",
        launches=launches, max_abs_err=max_abs_err, ms=min(ka, kb),
        plain_ms=min(pa, pb)))

    # ---- Vahadane (K2, K8, K9) --------------------------------------------
    # The main path, counted: the drop-in class (fit on one 256^2 image,
    # transform of one), the batched entry on B tiles (K2), and the
    # two-kernel pipeline on the same tiles (K8 then K9).
    vf.launches = vf.dict_launches = fs.launches = 0
    vnorm = st.ExtractiveStainNormalizer("vahadane", device=dev)
    vnorm.fit(target)
    vsingle = vnorm.transform(batch_np[0])
    vparams = extractive.ExtractiveParams(
        torch.from_numpy(vnorm.stain_matrix_target).to(dev),
        torch.from_numpy(vnorm.maxC_target[0]).to(dev))
    M, mc = vparams.stain_matrix_target, vparams.max_c_target
    vout = vf.vahadane_normalize(batch, M, mc, **VFAST)
    two = vf.vahadane_normalize_planar_2k(planar, M, mc)
    torch.cuda.synchronize()
    v_launches = dict(k2=vf.launches, k8=vf.dict_launches, k9=fs.launches)

    # 9. Drop-in path.
    assert all(n >= 1 for n in v_launches.values()), (
        f"a Vahadane kernel never launched on its path: {v_launches}")
    assert vsingle.dtype == np.uint8 and vsingle.shape == (SIDE, SIDE, 3)
    assert np.isfinite(vnorm.stain_matrix_target).all()
    assert (vsingle == vout[0].cpu().numpy()).all(), (
        "drop-in Vahadane transform differs from the batched kernel")
    log(9, f"drop-in vahadane fit+transform {SIDE}x{SIDE}: out "
           f"{vsingle.dtype} {vsingle.shape}, stain_matrix_target="
           f"{np.round(vnorm.stain_matrix_target, 4).tolist()} maxC_target="
           f"{np.round(vnorm.maxC_target, 4).tolist()}; main-path launches "
           f"K2={v_launches['k2']} K8={v_launches['k8']} "
           f"K9={v_launches['k9']}")

    # 10. Batched path: K2 against its plain version.
    vref = vf.vahadane_normalize_ref(batch, M, mc, **VFAST)
    assert vout.shape == batch.shape and vout.dtype == torch.uint8
    mx10, share10, _ = compare(vout, vref)
    assert mx10 <= 1 and share10 < 1e-3, (mx10, share10)
    k2_err = mx10
    log(10, f"K2 vs plain B={B} {SIDE}^2 fs=2 it=8 nb=10: max={mx10} u8, "
            f"share differing={share10:.3e} (gate: max<=1, share<1e-3)")

    # 11. The planar entry equals the interleaved one.
    vplanar = vf.vahadane_normalize_planar(planar, M, mc, **VFAST)
    assert torch.equal(vf.from_planar(vplanar, SIDE, SIDE), vout), (
        "planar and interleaved Vahadane entries disagree")
    log(11, "K2 planar entry identical to the interleaved entry")

    # 12. K2 against the functional path (validate_tpu.py:81's gate).
    vwant = extractive.transform(vparams, batch, method="vahadane")
    mx12, share12, over12 = compare(vout, vwant)
    assert mx12 <= 4 and over12 < 1e-2, (mx12, over12)
    log(12, f"K2 fs=2 it=8 nb=10 vs functional extractive.transform("
            f"method='vahadane'): max={mx12} u8, share differing="
            f"{share12:.3e}, share>1={over12:.3e} (gate: max<=4, "
            f"share>1<1e-2)")

    # 13. 512^2 tiles: K2 against its plain version.
    got = vf.vahadane_normalize(big512, M, mc, **VFAST)
    ref = vf.vahadane_normalize_ref(big512, M, mc, **VFAST)
    mx13, share13, _ = compare(got, ref)
    assert mx13 <= 1 and share13 < 1e-3, (mx13, share13)
    k2_err = max(k2_err, mx13)
    log(13, f"K2 vs plain B={B_LARGE} {SIDE_LARGE}^2 fs=2 it=8 nb=10: "
            f"max={mx13} u8, share differing={share13:.3e}")

    # 14. K8 against its plain version and the functional extractor.
    m_kernel = vf.vahadane_stain_matrix_planar(planar)
    m_plain = vf.vahadane_stain_matrix_planar_ref(planar)
    m_func = stain_matrix_vahadane(batch)
    e_plain = float((m_kernel - m_plain).abs().max())
    e_func = float((m_kernel - m_func).abs().max())
    assert e_plain <= 1e-5 and e_func <= 2e-3, (e_plain, e_func)
    log(14, f"K8 B={B} {SIDE}^2: max |M - plain| = {e_plain:.3e} (atol "
            f"1e-5), max |M - functional stain_matrix_vahadane| = "
            f"{e_func:.3e} (atol 2e-3)")

    k8_shapes = ((f"B={B} {SIDE}^2", planar),
                 (f"B={B_LARGE} {SIDE_LARGE}^2",
                  fs.to_planar(big512).contiguous()),
                 (f"B=1 {SIDE}^2", planar[:1].contiguous()))
    for label, pl in k8_shapes:
        g1 = vf._dict_launch(pl, g=1)
        assert torch.equal(g1, vf._dict_plane_ref(pl)), label
        for g in mf.CLUSTER_SIZES[1:]:
            assert torch.equal(vf._dict_launch(pl, g=g), g1), (label, g)
        assert torch.equal(vf._dict_launch(pl), g1), label
        log(14, f"K8 {label} fs=1 it=12 nb=14: clusters of "
                f"{list(mf.CLUSTER_SIZES)} blocks per tile and the plan's "
                f"each bit-identical to G=1 and to the plain version; "
                f"{plan_text('K8', pl.shape[2] * 128, None, pl.shape[0])}")

    # 15. K9 against its plain version, given the plain K8 matrices.
    k9 = fs.fused_normalize_planar(planar, m_plain, M, mc)
    k9_ref = fs.fused_normalize_planar_ref(planar, m_plain, M, mc)
    mx15, share15, _ = compare(k9, k9_ref)
    assert mx15 <= 1 and share15 < 1e-3, (mx15, share15)
    log(15, f"K9 vs plain B={B} {SIDE}^2: max={mx15} u8, share differing="
            f"{share15:.3e} (gate: max<=1, share<1e-3)")

    planar512 = fs.to_planar(big512).contiguous()
    k9_shapes = ((f"B={B} {SIDE}^2", planar, m_plain),
                 (f"B={B_LARGE} {SIDE_LARGE}^2", planar512,
                  vf.vahadane_stain_matrix_planar_ref(planar512)),
                 (f"B=1 {SIDE}^2", planar[:1].contiguous(), m_plain[:1]))
    for label, pl, rows in k9_shapes:
        want = fs.fused_normalize_planar_ref(pl, rows, M, mc)
        side = int((pl.shape[2] * pl.shape[3]) ** 0.5)
        il = fs.from_planar(pl, side, side).contiguous()
        for g in mf.CLUSTER_SIZES:
            assert torch.equal(fs._launch(pl, True, rows, M, mc, g=g),
                               want), (label, g)
            assert torch.equal(fs._launch(il, False, rows, M, mc, g=g),
                               fs.from_planar(want, side, side)), (label, g)
        assert torch.equal(fs.fused_normalize_planar(pl, rows, M, mc),
                           want), label
        log(15, f"K9 {label}: clusters of {list(mf.CLUSTER_SIZES)} blocks "
                f"per tile, planar and interleaved, and the plan's each "
                f"byte-identical to the plain version; "
                f"{plan_text('K9', side * side, None, pl.shape[0])}")

    # 16. The two-kernel pipeline against K2 at the same knobs.
    one = vf.vahadane_normalize_planar(planar, M, mc)
    mx16, share16, _ = compare(two, one)
    assert mx16 <= 1, mx16
    log(16, f"_2k (K8 then K9) vs K2, fs=1 it=12 nb=14: max={mx16} u8, "
            f"share differing={share16:.3e} (gate: max<=1)")

    # 17. Determinism.
    assert torch.equal(vf.vahadane_normalize(batch, M, mc, **VFAST), vout)
    assert torch.equal(vf.vahadane_stain_matrix_planar(planar), m_kernel)
    assert torch.equal(fs.fused_normalize_planar(planar, m_plain, M, mc), k9)
    log(17, "two runs of K2, K8 and K9 each byte-identical")

    # 18. Timing at the main path's shape, kernel and plain in turns.
    t2 = time_pair(lambda: vf.vahadane_normalize(batch, M, mc, **VFAST),
                   lambda: vf.vahadane_normalize_ref(batch, M, mc, **VFAST))
    t8 = time_pair(lambda: vf.vahadane_stain_matrix_planar(planar),
                   lambda: vf.vahadane_stain_matrix_planar_ref(planar))
    t9 = time_pair(
        lambda: fs.fused_normalize_planar(planar, m_plain, M, mc),
        lambda: fs.fused_normalize_planar_ref(planar, m_plain, M, mc))
    for label, ((ka, kb), (pa, pb)) in (("K2 fs=2 it=8 nb=10", t2),
                                        ("K8 fs=1 it=12 nb=14", t8),
                                        ("K9", t9)):
        log(18, f"{label} B={B} {SIDE}^2, median of {REPS} CUDA-event runs "
                f"(plain, kernel, kernel, plain): kernel {ka:.3f}/{kb:.3f} "
                f"ms = {B / min(ka, kb) * 1e3:.0f} tiles/s; plain "
                f"{pa:.3f}/{pb:.3f} ms; card '{smi}'")
    d2 = device_ms(lambda: vf.vahadane_normalize(batch, M, mc, **VFAST),
                   "vahadane_normalize_kernel")
    log(18, f"K2 fs=2 it=8 nb=10 B={B} {SIDE}^2, the kernel alone "
            f"(torch.profiler device time per call, {REPS} calls): "
            f"{fmt_ms(d2)}; {plan_text('K2', SIDE, 2)}; "
            f"{plan_text('K2', SIDE_LARGE, 2)}")
    for label, pl in k8_shapes:
        def k8_call(pl=pl):
            return vf.vahadane_stain_matrix_planar(pl)
        log(18, f"K8 {label} fs=1 it=12 nb=14: the kernel alone "
                f"(torch.profiler device time per call, {REPS} calls) "
                f"{fmt_ms(device_ms(k8_call, 'vahadane_dict_kernel'))}; by "
                f"events {time_ms(k8_call):.4f} ms (median of {REPS}); card "
                f"'{smi}'")
    for label, pl, rows in k9_shapes:
        def k9_call(pl=pl, rows=rows):
            return fs.fused_normalize_planar(pl, rows, M, mc)
        log(18, f"K9 {label}: the kernel alone (torch.profiler device time "
                f"per call, {REPS} calls) "
                f"{fmt_ms(device_ms(k9_call, 'fused_normalize_kernel'))}; by "
                f"events {time_ms(k9_call):.4f} ms (median of {REPS}); card "
                f"'{smi}'")
    kernels += [
        dict(name="vahadane_normalize_planar", route="cuda",
             source="stainlib_tpu_torch/kernels/csrc/vahadane_fused.cu",
             replaces="stainlib_tpu/kernels/vahadane_fused.py:342",
             launches=v_launches["k2"], max_abs_err=k2_err,
             ms=min(t2[0]), plain_ms=min(t2[1])),
        dict(name="vahadane_stain_matrix_planar", route="cuda",
             source="stainlib_tpu_torch/kernels/csrc/vahadane_fused.cu",
             replaces="stainlib_tpu/kernels/vahadane_fused.py:286",
             launches=v_launches["k8"], max_abs_err=e_plain,
             ms=min(t8[0]), plain_ms=min(t8[1])),
        dict(name="fused_normalize_planar", route="cuda",
             source="stainlib_tpu_torch/kernels/csrc/fused_stain.cu",
             replaces="stainlib_tpu/kernels/fused_stain.py:219",
             launches=v_launches["k9"], max_abs_err=mx15,
             ms=min(t9[0]), plain_ms=min(t9[1])),
    ]

    # ---- Large fields: the tiled route (K4, K3) ---------------------------
    # The main path, counted: the drop-in Macenko and Vahadane transform of
    # one 1024^2 and one 2048^2 image. Macenko estimates with K4 on the grid
    # subsample; both apply with K3 on the whole field.
    fields = {side: tiles(1, side, SEED + side)[0] for side in FIELDS}
    mf.matrix_launches = mf.fit_launches = 0
    dropin = {(m, side): nrm.transform(img)
              for m, nrm in (("macenko", norm), ("vahadane", vnorm))
              for side, img in fields.items()}
    torch.cuda.synchronize()
    t_launches = dict(k3=mf.matrix_launches, k4=mf.fit_launches)

    # 19. The drop-in route is transform_tiled at the API's grid stride.
    assert t_launches == dict(k3=4, k4=2), t_launches
    route = {}
    for (m, side), got in dropin.items():
        assert got.dtype == np.uint8 and got.shape == (side, side, 3)
        p = params if m == "macenko" else vparams
        x = torch.from_numpy(fields[side]).to(dev)
        s = extractive.tiled_est_stride(side, side)
        want = extractive.transform_tiled(p, x, method=m, est_stride=s)
        assert (want.cpu().numpy() == got).all(), (m, side)
        blocks = extractive.transform_tiled(p, x, method=m, est_stride=s,
                                            block=512)
        assert torch.equal(blocks, want), ("blockified K3 differs", m, side)
        route[(m, side)] = (p, x, s, want)
    log(19, f"drop-in transform of {'^2 and '.join(map(str, FIELDS))}^2 "
            f"fields, Macenko and Vahadane: uint8, equal to transform_tiled "
            f"at the API's est_stride and to its 512^2-blockified form; "
            f"main-path launches K3={t_launches['k3']} "
            f"K4={t_launches['k4']}")

    # 20. The tiled route against the functional transform on the full
    # field (tests/test_tiled_transform.py:99-106's budget).
    for (m, side), (p, x, s, got) in route.items():
        mx20, share20, over20 = compare(got, extractive.transform(
            p, x[None], method=m)[0])
        assert mx20 <= 3 and over20 < 1e-2, (m, side, mx20, over20)
        log(20, f"tiled {m} {side}^2 (est_stride={s}) vs functional "
                f"extractive.transform: max={mx20} u8, share differing="
                f"{share20:.3e}, share>1={over20:.3e} (gate: max<=3, "
                f"share>1<1e-2)")

    # 21. K3 and K4 against their plain versions on the same CUDA tensors:
    # the main path's shapes (one subsample, one whole field) and B tiles.
    M_mac, mc_mac = params.stain_matrix_target, params.max_c_target
    field = torch.from_numpy(fields[FIELDS[-1]]).to(dev)[None]
    stride = extractive.tiled_est_stride(FIELDS[-1], FIELDS[-1])
    sub = field[:, ::stride, ::stride].contiguous()  # the route's subsample
    sub_planar = fs.to_planar(sub).contiguous()
    k4_err = 0.0
    for pl in (sub_planar, planar):
        Mk, mck = mf.macenko_fit_planar(pl)
        Mp, mcp = mf.macenko_fit_planar_ref(pl)
        e_rows = float((Mk - Mp).abs().max())
        e_maxc = float(((mck - mcp).abs() / mcp.abs()).max())
        assert e_rows <= 1e-5 and e_maxc <= 1e-5, (e_rows, e_maxc)
        k4_err = max(k4_err, e_rows)
        log(21, f"K4 vs plain B={pl.shape[0]} {pl.shape[2] * 128} px: "
                f"max |rows| diff {e_rows:.3e} (atol 1e-5), maxC rel "
                f"{e_maxc:.3e} (rtol 1e-5)")
    Ms, mcs = mf.macenko_fit_planar(sub_planar)
    k3_args = (Ms, mcs, M_mac, mc_mac)
    k3 = mf.normalize_with_matrix(field, *k3_args)
    mx21, share21, _ = compare(k3, mf.normalize_with_matrix_ref(field,
                                                               *k3_args))
    Mt, mct = mf.macenko_fit_planar(planar)
    k3b = mf.normalize_with_matrix_planar(planar, Mt, mct, M_mac, mc_mac)
    mx21b, share21b, _ = compare(k3b, mf.normalize_with_matrix_planar_ref(
        planar, Mt, mct, M_mac, mc_mac))
    assert max(mx21, mx21b) <= 1 and max(share21, share21b) < 1e-3, (
        mx21, share21, mx21b, share21b)
    k3_err = max(mx21, mx21b)
    log(21, f"K3 vs plain {FIELDS[-1]}^2 field: max={mx21} u8, share "
            f"differing={share21:.3e}; B={B} {SIDE}^2 planar: max={mx21b} "
            f"u8, share differing={share21b:.3e} (gate: max<=1, "
            f"share<1e-3)")

    # 22. Determinism.
    assert torch.equal(mf.normalize_with_matrix(field, *k3_args), k3)
    assert torch.equal(mf.macenko_fit_planar(planar)[0], Mt)
    assert (norm.transform(fields[FIELDS[-1]])
            == dropin[("macenko", FIELDS[-1])]).all()
    log(22, "two runs of K3, K4 and the tiled drop-in each byte-identical")

    # 23. Timing, kernel and plain in turns: the main path's shapes (K4 on
    # one subsample, K3 on one field) and B tiles of 256^2.
    t4 = time_pair(lambda: mf.macenko_fit_planar(sub_planar),
                   lambda: mf.macenko_fit_planar_ref(sub_planar))
    t4b = time_pair(lambda: mf.macenko_fit_planar(planar),
                    lambda: mf.macenko_fit_planar_ref(planar))
    t3 = time_pair(lambda: mf.normalize_with_matrix(field, *k3_args),
                   lambda: mf.normalize_with_matrix_ref(field, *k3_args))
    t3b = time_pair(
        lambda: mf.normalize_with_matrix_planar(planar, Mt, mct, M_mac,
                                                mc_mac),
        lambda: mf.normalize_with_matrix_planar_ref(planar, Mt, mct, M_mac,
                                                    mc_mac))
    for label, ((ka, kb), (pa, pb)) in (
            (f"K4 B=1 {SIDE}^2 subsample", t4), (f"K4 B={B} {SIDE}^2", t4b),
            (f"K3 {FIELDS[-1]}^2 field", t3), (f"K3 B={B} {SIDE}^2", t3b)):
        log(23, f"{label}, median of {REPS} CUDA-event runs (plain, "
                f"kernel, kernel, plain): kernel {ka:.3f}/{kb:.3f} ms; "
                f"plain {pa:.3f}/{pb:.3f} ms; card '{smi}'")
    for label, fn in (
            (f"{FIELDS[-1]}^2 field",
             lambda: mf.normalize_with_matrix(field, *k3_args)),
            (f"B={B} {SIDE}^2 planar", lambda: mf.normalize_with_matrix_planar(
                planar, Mt, mct, M_mac, mc_mac))):
        log(23, f"K3 {label}, the kernel alone (torch.profiler device time "
                f"per call, {REPS} calls): "
                f"{fmt_ms(device_ms(fn, 'matrix_apply_kernel'))}")
    # With its values ready on the device as float32, K3's entry is one
    # launch: the wrapper builds no table (no cat, fill, div or clamp).
    k3_dev = [t.to(dev, torch.float32).contiguous() for t in k3_args]
    names = device_events(lambda: mf.normalize_with_matrix(field, *k3_dev))
    assert not names or (len(names) == 1
                         and "matrix_apply_kernel" in names[0]), names
    log(23, f"K3 entry on {FIELDS[-1]}^2 with float32 device values, device "
            f"activities of 3 calls (torch.profiler): "
            f"{names or 'not measured'}")
    for label, pl in ((f"one {SIDE}^2 subsample", sub_planar),
                      (f"B={B} {SIDE}^2", planar)):
        d4 = device_ms(lambda: mf.macenko_fit_planar(pl), "macenko_fit_kernel")
        log(23, f"K4 {label}, the kernel alone (torch.profiler device time "
                f"per call, {REPS} calls): {fmt_ms(d4)}; "
                f"{plan_text('K4', pl.shape[2] * 128)}")
    kernels += [
        dict(name="normalize_with_matrix_planar", route="cuda",
             source="stainlib_tpu_torch/kernels/csrc/macenko_fused.cu",
             replaces="stainlib_tpu/kernels/macenko_fused.py:936",
             launches=t_launches["k3"], max_abs_err=k3_err,
             ms=min(t3[0]), plain_ms=min(t3[1])),
        dict(name="macenko_fit_planar", route="cuda",
             source="stainlib_tpu_torch/kernels/csrc/macenko_fused.cu",
             replaces="stainlib_tpu/kernels/macenko_fused.py:688",
             launches=t_launches["k4"], max_abs_err=k4_err,
             ms=min(t4[0]), plain_ms=min(t4[1])),
    ]

    # ---- K10: eigenplane --------------------------------------------------
    # No drop-in caller: the path is the entry itself on B tiles, counted.
    mf.eigenplane_launches = 0
    V = mf.eigenplane(planar)
    torch.cuda.synchronize()
    k10_launches = mf.eigenplane_launches

    # 24. K10 against its plain version; determinism; timing.
    assert k10_launches == 1 and V.shape == (B, 3, 2)
    assert torch.isfinite(V).all()
    e10 = float((V - mf.eigenplane_ref(planar)).abs().max())
    assert e10 <= 1e-6, e10
    assert torch.equal(mf.eigenplane(planar), V)
    t10 = time_pair(lambda: mf.eigenplane(planar),
                    lambda: mf.eigenplane_ref(planar))
    (ka, kb), (pa, pb) = t10
    log(24, f"K10 eigenplane B={B} {SIDE}^2: max |V - plain| = {e10:.3e} "
            f"(atol 1e-6), rerun identical, main-path launches="
            f"{k10_launches}; kernel {ka:.3f}/{kb:.3f} ms, plain "
            f"{pa:.3f}/{pb:.3f} ms (plain, kernel, kernel, plain, median "
            f"of {REPS}); card '{smi}'")
    # The same bits at every cluster size, and within the plain version's
    # budget, at the three batches the plan treats differently.
    planar512 = fs.to_planar(big512).contiguous()
    for label, x in ((f"B={B} {SIDE}^2", planar),
                     (f"B={B_LARGE} {SIDE_LARGE}^2", planar512),
                     (f"B=1 {SIDE}^2", planar[:1].contiguous())):
        Vx = mf.eigenplane(x)
        ex = float((Vx - mf.eigenplane_ref(x)).abs().max())
        assert ex <= 1e-6, (label, ex)
        for g in mf.CLUSTER_SIZES:
            assert torch.equal(mf._eigen_launch(x, g=g), Vx), (label, g)
        e10 = max(e10, ex)
        d10 = device_ms(lambda: mf.eigenplane(x), "eigenplane_kernel")
        G = mf.eigenplane_plan(x.shape[0], x.shape[2] * 128,
                               mf.sm_count(dev))
        log(24, f"K10 {label}: max |V - plain| = {ex:.3e} (atol 1e-6); "
                f"clusters of {list(mf.CLUSTER_SIZES)} blocks per tile and "
                f"the plan's (G={G}) bit-identical; the kernel alone "
                f"(torch.profiler device time per call, {REPS} calls) "
                f"{fmt_ms(d10)}, by events {time_ms(lambda: mf.eigenplane(x)):.4f} ms "
                f"(median of {REPS}); card '{smi}'")
    names = device_events(lambda: mf.eigenplane(planar))
    assert not names or (len(names) == 1
                         and "eigenplane_kernel" in names[0]), names
    log(24, f"K10 entry B={B} {SIDE}^2, device activities of 3 calls "
            f"(torch.profiler): {names or 'not measured'}; no path of the "
            f"port calls eigenplane")
    kernels.append(dict(
        name="eigenplane", route="cuda",
        source="stainlib_tpu_torch/kernels/csrc/macenko_fused.cu",
        replaces="stainlib_tpu/kernels/macenko_fused.py:498",
        launches=k10_launches, max_abs_err=e10, ms=min(t10[0]),
        plain_ms=min(t10[1])))

    # ---- Reinhard (K5) ----------------------------------------------------
    # The main path, counted: the drop-in class on one 256^2 image, then
    # the batched entry on B tiles of 256^2 and B_LARGE of 512^2.
    rf.launches = 0
    rnorm = st.ReinhardStainNormalizer(device=dev)
    rnorm.fit(target)
    rsingle = rnorm.transform(batch_np[0])
    means = torch.from_numpy(rnorm.target_means).to(dev)
    stds = torch.from_numpy(rnorm.target_stds).to(dev)
    rout = rf.reinhard_normalize(batch, means, stds)
    rbig = rf.reinhard_normalize(big512, means, stds)
    torch.cuda.synchronize()
    r_launches = rf.launches

    # 25. Drop-in path.
    assert r_launches == 3, r_launches
    assert rsingle.dtype == np.uint8 and rsingle.shape == (SIDE, SIDE, 3)
    assert np.isfinite(rnorm.target_means).all()
    assert (rsingle == rout[0].cpu().numpy()).all(), (
        "drop-in Reinhard transform differs from the batched kernel")
    log(25, f"drop-in Reinhard fit+transform {SIDE}x{SIDE}: out "
            f"{rsingle.dtype} {rsingle.shape}, target_means="
            f"{np.round(rnorm.target_means, 4).tolist()} target_stds="
            f"{np.round(rnorm.target_stds, 4).tolist()}; main-path "
            f"launches={r_launches}")

    # 26. K5 against its plain version, at both tile sizes.
    mx26, share26, _ = compare(rout, rf.reinhard_normalize_ref(batch, means,
                                                               stds))
    mx26b, share26b, _ = compare(rbig, rf.reinhard_normalize_ref(
        big512, means, stds))
    assert max(mx26, mx26b) <= 1 and max(share26, share26b) < 1e-3, (
        mx26, share26, mx26b, share26b)
    log(26, f"K5 vs plain B={B} {SIDE}^2: max={mx26} u8, share differing="
            f"{share26:.3e}; B={B_LARGE} {SIDE_LARGE}^2: max={mx26b} u8, "
            f"share differing={share26b:.3e} (gate: max<=1, share<1e-3)")

    for label, x in k1_shapes:
        g1 = rf._launch(x, False, means, stds, g=1)
        for g in rf.CLUSTER_SIZES[1:]:
            assert torch.equal(rf._launch(x, False, means, stds, g=g), g1), (
                label, g)
        assert torch.equal(rf.reinhard_normalize(x, means, stds), g1), label
        log(26, f"K5 {label}: clusters of {list(rf.CLUSTER_SIZES)} blocks "
                f"per tile and the plan's each byte-identical to G=1; "
                f"{k5_plan_text(x)}")
    assert torch.equal(rf.reinhard_normalize(one256, means, stds)[0], rout[0])

    # 27. K5 against the functional reinhard.transform
    # (tests/test_reinhard_fused.py:23-24's budget). The gate holds the
    # functional path evaluated on the CPU, where the tests hold it to the
    # JAX package; its evaluation on the card is reported beside it.
    rparams = reinhard.ReinhardParams(means, stds)
    cpu_params = reinhard.ReinhardParams(means.cpu(), stds.cpu())
    want_cpu = reinhard.transform(cpu_params, batch.cpu())
    mx27, share27, over27 = compare(rout.cpu(), want_cpu)
    assert mx27 <= 3 and share27 < 1e-2, (mx27, share27)
    mx27c, share27c, over27c = compare(rout, reinhard.transform(rparams,
                                                                batch))
    assert share27c < 1e-2, share27c
    rf_card_cpu = compare(reinhard.transform(rparams, batch).cpu(), want_cpu)
    log(27, f"K5 vs functional reinhard.transform on the CPU: max={mx27} "
            f"u8, share differing={share27:.3e}, share>1={over27:.3e} "
            f"(gate: <=1 on >99%, max<=3); vs the functional path on the "
            f"card: max={mx27c} u8, share differing={share27c:.3e}, "
            f"share>1={over27c:.3e}")

    # 28. Determinism.
    assert torch.equal(rf.reinhard_normalize(batch, means, stds), rout)
    assert torch.equal(rf.reinhard_normalize_planar(
        planar, means, stds), fs.to_planar(rout))
    log(28, "two K5 runs byte-identical; planar entry identical")

    # 29. Timing at the main path's shapes, kernel and plain in turns.
    t5 = time_pair(lambda: rf.reinhard_normalize(batch, means, stds),
                   lambda: rf.reinhard_normalize_ref(batch, means, stds))
    t5b = time_pair(lambda: rf.reinhard_normalize(big512, means, stds),
                    lambda: rf.reinhard_normalize_ref(big512, means, stds))
    t5c = time_pair(lambda: rf.reinhard_normalize(one256, means, stds),
                    lambda: rf.reinhard_normalize_ref(one256, means, stds))
    for label, ((ka, kb), (pa, pb)), x in (
            (f"B={B} {SIDE}^2", t5, batch),
            (f"B={B_LARGE} {SIDE_LARGE}^2", t5b, big512),
            (f"B=1 {SIDE}^2", t5c, one256)):
        d5 = device_ms(lambda: rf.reinhard_normalize(x, means, stds),
                       "reinhard_kernel")
        log(29, f"K5 {label}, median of {REPS} CUDA-event runs (plain, "
                f"kernel, kernel, plain): kernel {ka:.4f}/{kb:.4f} ms = "
                f"{x.shape[0] / min(ka, kb) * 1e3:.0f} tiles/s; plain "
                f"{pa:.3f}/{pb:.3f} ms; the kernel alone (torch.profiler "
                f"device time per call, {REPS} calls): {fmt_ms(d5)}; "
                f"{k5_plan_text(x)}; card '{smi}'")
    kernels.append(dict(
        name="reinhard_normalize_planar", route="cuda",
        source="stainlib_tpu_torch/kernels/csrc/reinhard_fused.cu",
        replaces="stainlib_tpu/kernels/reinhard_fused.py:197",
        launches=r_launches, max_abs_err=max(mx26, mx26b), ms=min(t5[0]),
        plain_ms=min(t5[1])))

    # ---- Stain augmentation (K6, K7; K8 reused) ---------------------------
    kernels += augment_phases(dev, smi, batch, batch_np, planar, big512)

    # 37. The functional paths on the card against their CPU evaluation
    # (reported, not gated): fixed-order contractions round alike on both;
    # torch.pow, log and exp in CUDA's libm still may not.
    mx37, share37, over37 = compare(mac_func_card.cpu(), extractive.transform(
        extractive.ExtractiveParams(params.stain_matrix_target.cpu(),
                                    params.max_c_target.cpu()), batch.cpu()))
    log(37, f"functional Macenko extractive.transform B={B} {SIDE}^2 on the "
            f"card vs on the CPU: max={mx37} u8, share differing="
            f"{share37:.3e}, share>1={over37:.3e}; functional Reinhard: "
            f"max={rf_card_cpu[0]} u8, share differing="
            f"{rf_card_cpu[1]:.3e}, share>1={rf_card_cpu[2]:.3e} (phase 27)")

    # ---- F1: the flow's residual-branch kernels ---------------------------
    f1 = flow_branch_phase(smi)

    # ---- This tree against the parent's, where it is unpacked beside it
    parent_phases()

    # ---- Whole-slide deployment (K3, K1, K2, K5 on slides) -------------
    # Phases 48-51 (the flow + GMM model and its trainer) run on the
    # slide phases' work directory: phase 51 trains on its slide.
    slide_launches = slide_phases(dev, smi, then=flow_phases)
    routes = {r[2]: name for name, r in SLIDE_ROUTES.items()}
    routes["augment_with_matrix_planar"] = "K7"  # the examples' pops
    for k in kernels:
        route = routes.get(k["name"])
        if route is None:
            continue
        if route in slide_launches:
            k["slide_launches"] = slide_launches[route]
        # The paths of phases 45-47 (sharded normalize, the training-tile
        # stream, normalize_slide over a mesh) and 66-67 (the scale drive,
        # the demo and the notebook).
        for path in ("sharded", "stream", "mesh_slide", "scale", "example"):
            if f"{route}_{path}" in slide_launches:
                k[f"{path}_launches"] = slide_launches[f"{route}_{path}"]

    # ---- The chip commands: validation, the probe grid, entry() ---------
    command_phases(dev, smi)

    # Each kernel's bound at the shapes of its timed call, with the tissue
    # share of these inputs (the masked passes count tissue pixels only).
    n_sub = sub_planar.shape[2] * sub_planar.shape[3]
    t_batch = float(mf._od_and_mask(planar, 0.8)[3].float().mean())
    t_sub = float(mf._od_and_mask(sub_planar, 0.8)[3].float().mean())
    n_tile = SIDE * SIDE
    shapes = {
        "macenko_normalize_planar": ("K1", B, n_tile, t_batch),
        "vahadane_normalize_planar": ("K2", B, n_tile, t_batch),
        "vahadane_stain_matrix_planar": ("K8", B, n_tile, t_batch),
        "fused_normalize_planar": ("K9", B, n_tile),
        "normalize_with_matrix_planar": ("K3", 1, FIELDS[-1] ** 2),
        "macenko_fit_planar": ("K4", 1, n_sub, t_sub),
        "eigenplane": ("K10", B, n_tile, t_batch),
        "reinhard_normalize_planar": ("K5", B, n_tile),
        "macenko_augment_planar": ("K6", B, n_tile, t_batch),
        "augment_with_matrix_planar": ("K7", B, n_tile),
    }
    log(37, f"tissue share of the B={B} batch {t_batch:.4f}, of the "
            f"{FIELDS[-1]}^2 field's subsample {t_sub:.4f} (the bounds' "
            f"masked passes)")
    for k in kernels:
        k.update(bound(*shapes[k["name"]]), library_ms=None)
    f1["launches"] = slide_launches["F1_flow"]
    kernels.append(f1)
    assert len(kernels) == 11, [k["name"] for k in kernels]

    log(71, f"the whole run, phases 1-71: "
            f"{time.perf_counter() - t_run:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
