#!/usr/bin/env python
"""Reference-scale whole-slide drive: >=20k tiles (>2 GB level-0) end to end.

The PyTorch port's counterpart of ``scripts/bench_wsi_scale.py``. The
reference's ``tester`` deployment iterates 100k+ patches per slide
(``dlmodels/color-information/data_utils.py:1``); this script proves the
memmap-canvas deployment story at that scale: generate a synthetic H&E
slide whose level 0 exceeds the RAM-canvas threshold
(``normalization.slide._RAM_CANVAS_BYTES``), push it through
``normalize_slide`` on the card (threaded decode -> prefetch ring -> the
fixed-matrix kernel K3 once per batch in slide mode; K1, K2 or K5 with
``--estimation tile`` -> pyramidal TIFF), and report wall time,
steady-state tiles/s, the host-clock time of each part (fit, stream,
pyramid, write; a synchronize after each), whether level 0's canvas was a
disk memmap or RAM, peak RSS (the process's, the input's generation
included: run again with ``--keep`` on the kept input for the drive's
alone) and the resident anonymous and file-backed memory at the end.

``--container svs`` (the default) writes the input as a JPEG .svs and needs
libtiff; ``--container wsiraw`` writes it through ``native.write_wsiraw``.
``--no-write`` skips the output TIFF (``write_tiff_pyramid``) and reports
``"out_gb": null`` and the write as not run. A host without libtiff needs
both ``--container wsiraw`` and ``--no-write``; without them the script
stops before it generates anything.

    python scripts/torch_bench_wsi_scale.py --side 36864   # 20,736 tiles
    python scripts/torch_bench_wsi_scale.py --container wsiraw --no-write
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import resource
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--side", type=int, default=36864,
                   help="level-0 side in px (36864 -> 20,736 256-tiles, "
                        "4.1 GB raw)")
    p.add_argument("--tile", type=int, default=256)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--method", default="macenko")
    p.add_argument("--estimation", default="slide")
    p.add_argument("--workdir",
                   default=os.path.join(tempfile.gettempdir(), "wsi_scale"))
    p.add_argument("--keep", action="store_true",
                   help="keep the generated input/output slides")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--container", choices=("svs", "wsiraw"), default="svs",
                   help="the input's container (svs needs libtiff)")
    p.add_argument("--no-write", action="store_true",
                   help="skip the output TIFF (write_tiff_pyramid)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs the functional path)")
    return p.parse_args(argv)


def synth_level0(side: int, tile: int, seed: int):
    """A side x side H&E-like field written in tile rows (bounded temps):
    smooth sinusoidal concentration fields + noise, white margin band."""
    import numpy as np

    he = np.array([[0.55, 0.72, 0.42], [0.17, 0.80, 0.57]])
    he /= np.linalg.norm(he, axis=1, keepdims=True)
    rng = np.random.default_rng(seed)
    lv0 = np.empty((side, side, 3), np.uint8)
    xs = np.arange(side, dtype=np.float32)
    for r0 in range(0, side, tile):
        r1 = min(r0 + tile, side)
        yy = np.arange(r0, r1, dtype=np.float32)[:, None]
        c_h = np.clip(0.8 + 0.6 * np.sin(yy / 9.0) * np.cos(xs / 7.0),
                      0, None)
        c_e = np.clip(0.6 + 0.4 * np.cos(yy / 11.0) * np.sin(xs / 5.0),
                      0, None)
        C = np.stack([c_h, c_e], -1).astype(np.float32)
        C *= 0.9 + 0.2 * rng.random((r1 - r0, side, 2), np.float32)
        img = 255.0 * np.exp(-(C @ he.astype(np.float32)))
        lv0[r0:r1] = np.clip(img, 0, 255).astype(np.uint8)
    # White margin (background rejection + partial-tile handling).
    m = tile // 2
    lv0[:m] = 255
    lv0[:, :m] = 255
    return lv0


@contextlib.contextmanager
def timed_parts(sl, dev, write: bool):
    """Swap ``normalize_slide``'s parts in the slide module ``sl`` for
    wrappers that time each on the host clock, a device synchronize after
    each, for the block. Yields ``(times, seen)``: seconds per part (fit,
    stream, pyramid, write; None where a part did not run) and level 0's
    canvas under ``seen["canvas"]``. With ``write`` false the TIFF writer
    is not called."""
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    times = dict(fit=None, stream=None, pyramid=None, write=None)
    seen = {}
    parts = {"fit_slide": "fit", "fit_slide_reinhard": "fit",
             "_stream_canvas": "stream", "build_pyramid": "pyramid",
             "write_tiff_pyramid": "write"}
    real = {name: getattr(sl, name) for name in parts}

    def timed(name):
        def call(*a, **k):
            if name == "write_tiff_pyramid" and not write:
                return None
            sync()
            t0 = time.perf_counter()
            res = real[name](*a, **k)
            sync()
            times[parts[name]] = time.perf_counter() - t0
            if name == "_stream_canvas":
                seen["canvas"] = res[0]
            return res
        return call

    for name in parts:
        setattr(sl, name, timed(name))
    try:
        yield times, seen
    finally:
        for name, fn in real.items():
            setattr(sl, name, fn)


def _rss_split():
    """{"anon": GiB, "file": GiB} resident now, from ``/proc/self/statm``
    (None where it cannot be read): anonymous memory apart from the shared
    pages of mapped files (the input's mmap, the memmap canvas and
    pyramid), which count as resident while the host has memory to
    spare."""
    try:
        with open("/proc/self/statm") as f:
            resident, shared = (int(v) for v in f.read().split()[1:3])
    except (OSError, ValueError):
        return None
    page = os.sysconf("SC_PAGE_SIZE") / 2**30
    return {"anon": round((resident - shared) * page, 2),
            "file": round(shared * page, 2)}


def drive(args):
    """Generate (or reuse) the input slide, normalize it and return
    ``(summary, level-0 canvas)``."""
    import numpy as np
    import torch

    from stainlib_tpu_torch.api import _device
    from stainlib_tpu_torch.data import native
    from stainlib_tpu_torch.normalization import slide as sl

    svs = args.container == "svs"
    if (svs or not args.no_write) and not native.tiff_native_available():
        raise SystemExit(
            "torch_bench_wsi_scale: this host has no libtiff, so the "
            + ("input .svs" if svs else "output TIFF")
            + " cannot be written; pass --container wsiraw --no-write")
    dev = _device(args.device)

    os.makedirs(args.workdir, exist_ok=True)
    src = os.path.join(args.workdir,
                       "scale_in.svs" if svs else "scale_in.wsiraw")
    out = os.path.join(args.workdir, "scale_out.tif")

    t_gen = time.perf_counter()
    if not os.path.exists(src):
        lv0 = synth_level0(args.side, args.tile, args.seed)
        gb = lv0.nbytes / 2**30
        print(f"generated level-0 {args.side}^2 ({gb:.2f} GB raw) "
              f"in {time.perf_counter() - t_gen:.0f}s", flush=True)
        if svs:
            native.write_tiff_pyramid(src, [lv0], tile=args.tile,
                                      compression="jpeg")
        else:
            native.write_wsiraw(src, [lv0])
        del lv0
        print(f"wrote {src} ({os.path.getsize(src) / 2**30:.2f} GB) "
              f"in {time.perf_counter() - t_gen:.0f}s total", flush=True)

    marks = []  # (batch_index, t) from the progress callback

    def progress(done, total):
        marks.append((done, time.perf_counter()))
        if done % 20 == 0 or done == total:
            print(f"  {done}/{total} batches", flush=True)

    with timed_parts(sl, dev, write=not args.no_write) as (parts, seen):
        t0 = time.perf_counter()
        info = sl.normalize_slide(src, out, _target(),
                                  method=args.method,
                                  estimation=args.estimation,
                                  tile=args.tile, batch=args.batch,
                                  progress=progress, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        rss_end = _rss_split()  # level 0's canvas still alive
    peak_rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    canvas = seen["canvas"]

    # Steady-state rate: drop the first 10% of batches (build + warm-up),
    # slope over the rest. Degenerate for tiny smokes (< 3 batches): fall
    # back to the end-to-end rate.
    n = len(marks)
    k = max(1, n // 10)
    (b0, s0), (b1, s1) = marks[k - 1], marks[-1]
    steady = ((b1 - b0) * args.batch / max(s1 - s0, 1e-9)
              if b1 > b0 else info["tiles"] / wall)

    summary = {
        "side": args.side, "tiles": info["tiles"],
        "level0_gb": round(args.side * args.side * 3 / 2**30, 2),
        "fused": info["fused"], "estimation": info["estimation"],
        "wall_s": round(wall, 1),
        "tiles_per_s_end_to_end": round(info["tiles"] / wall, 1),
        "tiles_per_s_steady": round(steady, 1),
        "peak_rss_gb": round(peak_rss_gb, 2),
        "rss_end_gb": rss_end,
        "out_gb": (None if args.no_write
                   else round(os.path.getsize(out) / 2**30, 2)),
        "container": args.container,
        "canvas": "memmap" if isinstance(canvas, np.memmap) else "ram",
        "parts_s": {k: None if v is None else round(v, 3)
                    for k, v in parts.items()},
        "batch": args.batch, "device": str(dev),
    }
    print(json.dumps(summary), flush=True)
    with open(os.path.join(args.workdir, "wsi_scale.json"), "w") as f:
        json.dump(summary, f, indent=2)
    if not args.keep:
        os.remove(src)
        if os.path.exists(out):
            os.remove(out)
    return summary, canvas


def run(args):
    return drive(args)[0]


def _target():
    import numpy as np

    stain = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]])
    stain = stain / np.linalg.norm(stain, axis=1, keepdims=True)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float64)
    c_h = 0.9 + 0.5 * np.sin(yy / 17.0) * np.cos(xx / 13.0)
    c_e = 0.7 + 0.3 * np.cos(yy / 11.0) * np.sin(xx / 7.0)
    C = np.clip(np.stack([c_h, c_e], -1), 0, None)
    img = 255.0 * np.exp(-(C @ stain))
    return np.clip(img, 0, 255).astype(np.uint8)


def main(argv=None) -> int:
    run(parse_args(sys.argv[1:] if argv is None else argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
