"""Smoke run of the PyTorch/CUDA port's main path on one GPU.

    python3 chip_smoke.py

Drives ``stainlib_tpu_torch``'s Macenko normalize path on the card: the
drop-in ``ExtractiveStainNormalizer("macenko")`` and the batched
``macenko_normalize`` entry on 256x256 uint8 H&E tiles (random synthetic
tiles from a seed). It builds the hand-written CUDA kernel from the sources
in the checkout, holds it against its plain PyTorch version and against the
functional path, checks that two runs give identical bytes, and times the
kernel against the plain version with CUDA events.

Phases print one line each. Before the last line it prints the card's name
and power limit (``nvidia-smi``) and a JSON object describing each kernel;
the last line is ``{"ok": true, "device": {...}}``. Any failure raises and
the script exits non-zero; without a CUDA device it exits non-zero and
prints no result. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 20261016
B, SIDE = 256, 256  # the batched main path: 256 tiles of 256x256
B_LARGE, SIDE_LARGE = 16, 512
FAST = dict(fit_stride=2, n_bisect=10)  # the API's knobs at >= 256^2
REPS = 15


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def tiles(n, side, seed):
    """Synthetic H&E tiles from ``tests/synth.py``, loaded by path (another
    installed ``tests`` package may shadow the repo's)."""
    path = Path(__file__).resolve().parent / "tests" / "synth.py"
    spec = importlib.util.spec_from_file_location("stain_synth", path)
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    return synth.he_batch(n, side, side, seed=seed)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to PyTorch", file=sys.stderr)
        return 2

    return run(torch.device("cuda", 0))


def run(dev) -> int:
    import stainlib_tpu_torch as st
    from stainlib_tpu_torch.kernels import _build
    from stainlib_tpu_torch.kernels import macenko_fused as mf
    from stainlib_tpu_torch.normalization import extractive

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
    regs = [ln.strip() for ln in _build.build_info.get("log", "").splitlines()
            if "registers" in ln or "spill" in ln]
    log(2, f"built={_build.build_info['built']} nvcc_s="
           f"{_build.build_info['seconds']:.2f} load_s={build_s:.2f} "
           f"ptxas: {' | '.join(regs)}")

    target = tiles(1, SIDE, SEED)[0]
    batch_np = tiles(B, SIDE, SEED + 1)
    batch = torch.from_numpy(batch_np).to(dev)

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
    planar = mf.to_planar(batch).contiguous()
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
    log(4, f"kernel vs plain B={B} {SIDE}^2 fs=2 nb=10: max={mx} u8, "
           f"share differing={share:.3e} (gate: max<=1, share<1e-3); "
           f"planar entry identical")
    max_abs_err = mx

    # 5. Kernel against the port's functional path (validate_tpu.py gate).
    want = extractive.transform(params, batch)
    mx5, _, over1 = compare(out, want)
    assert mx5 <= 2 and over1 < 1e-2, (mx5, over1)
    log(5, f"kernel vs functional extractive.transform: max={mx5} u8, "
           f"share>1={over1:.3e} (gate: max<=2, share>1<1e-2)")

    # 6. Determinism.
    again = mf.macenko_normalize(batch, params.stain_matrix_target,
                                 params.max_c_target, **FAST)
    assert torch.equal(out, again), "two runs differ"
    log(6, "two kernel runs byte-identical")

    # 7. 512^2 tiles: kernel against plain version.
    big = torch.from_numpy(tiles(B_LARGE, SIDE_LARGE, SEED + 7)).to(dev)
    got = mf.macenko_normalize(big, params.stain_matrix_target,
                               params.max_c_target, **FAST)
    ref = mf.macenko_normalize_ref(big, params.stain_matrix_target,
                                   params.max_c_target, **FAST)
    mx7, share7, _ = compare(got, ref)
    assert mx7 <= 1 and share7 < 1e-3, (mx7, share7)
    max_abs_err = max(max_abs_err, mx7)
    log(7, f"kernel vs plain B={B_LARGE} {SIDE_LARGE}^2 fs=2: max={mx7} u8, "
           f"share differing={share7:.3e}")

    # 8. Timing at the main path's shape, kernel and plain in turns.
    def kernel():
        mf.macenko_normalize(batch, params.stain_matrix_target,
                             params.max_c_target, **FAST)

    def plain():
        mf.macenko_normalize_ref(batch, params.stain_matrix_target,
                                 params.max_c_target, **FAST)

    ms_plain_a = time_ms(plain)
    ms_kernel_a = time_ms(kernel)
    ms_kernel_b = time_ms(kernel)
    ms_plain_b = time_ms(plain)
    ms_kernel = min(ms_kernel_a, ms_kernel_b)
    ms_plain = min(ms_plain_a, ms_plain_b)
    log(8, f"B={B} {SIDE}^2 fs=2 nb=10, median of {REPS} CUDA-event runs "
           f"(plain, kernel, kernel, plain): kernel {ms_kernel_a:.3f}/"
           f"{ms_kernel_b:.3f} ms = {B / ms_kernel * 1e3:.0f} tiles/s; plain "
           f"{ms_plain_a:.3f}/{ms_plain_b:.3f} ms = "
           f"{B / ms_plain * 1e3:.0f} tiles/s; card '{smi}'")

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "macenko_normalize_planar",
        "route": "cuda",
        "source": "stainlib_tpu_torch/kernels/csrc/macenko_fused.cu",
        "replaces": "stainlib_tpu/kernels/macenko_fused.py:541",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms_kernel,
        "plain_ms": ms_plain,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
