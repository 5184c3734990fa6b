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
* whole-slide deployment (phases 41-44): ``normalize_slide`` on a
  16,384x16,384 synthetic WSIRAW slide (4,096 tiles of 256x256) in slide
  mode (K3 once per batch of 64), timed by parts (fit, stream, pyramid,
  write) on the host clock, the stream traced by ``torch.profiler`` (K3's
  device time, the device's idle share); the four kernel routes (K3 slide
  mode, K1, K2 and K5 tile mode) on a 2000x2300 slide against their plain
  versions byte for byte, the functional path's budget and a second run;
  and the four routes end to end at 4096x4096. Where the host has no
  libtiff the TIFF writer is not run (a line says so) and level 0 is read
  from the canvas the stream fills.

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
whole-slide phases (``slide_launches``), and ``bound_ms``, the least time the card
could take for the same work (the larger of its bytes over 3.35 TB/s and
its float32 operations over 67 TFLOP/s, counted from the shapes of the
timed call and the tissue share of its inputs); the last line is
``{"ok": true, "device": {...}}``. Any failure raises and the script exits
non-zero; without a CUDA device it exits non-zero and prints no result.
Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import importlib.util
import json
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


# ---- Whole-slide deployment (phases 41-45) ----------------------------------

SLIDE_SIDE = 16384  # 805 MB of level 0, 4,096 tiles of 256^2
SLIDE_SMALL = (2000, 2300)  # width, height: partial tiles on both edges
SLIDE_MID = 4096  # 256 tiles: the four routes end to end
SLIDE_BATCH = 64
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


def slide_phases(dev, smi) -> dict:
    """Phases 41-45: whole-slide deployment through
    ``normalization.slide.normalize_slide``, the user's entry point (the
    reference's ``tester`` loop): a 16,384^2 slide in slide mode (K3), then
    the four kernel routes (K3, K1, K2, K5) at 2000x2300 against their
    plain versions and the functional path, and end to end at 4096^2.
    Returns each route's launches on its main run (phase 42 for K3, phase
    44 for K1, K2 and K5)."""
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
        native.write_wsiraw(big, [lv0])
        t_write = time.perf_counter() - t0
        s = native.open_slide(big)
        is_native = s.native
        assert isinstance(s, native.RawSlide) and is_native, (
            "the native WSIRAW reader did not load")
        assert s.level_size(0) == (SLIDE_SIDE, SLIDE_SIDE)
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
    return launches


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

    # ---- This tree against the parent's, where it is unpacked beside it
    parent_phases()

    # ---- Whole-slide deployment (K3, K1, K2, K5 on slides) -------------
    slide_launches = slide_phases(dev, smi)
    for k in kernels:
        route = {r[2]: name for name, r in SLIDE_ROUTES.items()}.get(k["name"])
        if route is not None:
            k["slide_launches"] = slide_launches[route]

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
    assert len(kernels) == 10, [k["name"] for k in kernels]

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
