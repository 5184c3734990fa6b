#!/usr/bin/env python
"""Host-side slide-decode throughput and its thread-count scaling.

The PyTorch port's counterpart of ``scripts/bench_host_ingestion.py``, on
the port's readers (``stainlib_tpu_torch.data.native``). It measures the
host alone (no device): the decode that feeds the slide stream
(``normalization.slide._stream_canvas``) and the training feed
(``data.wsi.WsiSampler``).

``--container svs`` (the default) measures the C++ libtiff reader
(``tiffreader.cpp``) on a synthetic .svs-layout JPEG slide: random
rejection sampling (``tf_sample_tiles``, the train path) and batched grid
decode (``tf_read_regions``, the eval path) at STAINLIB_TIFF_THREADS in
``--threads``. It needs libtiff; without it the script prints an error
line and returns 1.

``--container wsiraw`` measures the WSIRAW reader (``tilereader.cpp``), the
container a host without libtiff streams: ``RawSlide.sample_tiles`` (the
train path) and one ``read_region`` per tile, stacked (the eval path, as
``_stream_canvas`` reads WSIRAW). That reader takes no thread setting (it
uses every hardware thread), so it prints one row at its own thread count
and ``--threads`` applies to TIFF only.

    python scripts/torch_bench_host_ingestion.py --size 4096 --tile 256
    python scripts/torch_bench_host_ingestion.py --container wsiraw
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stainlib_tpu_torch.data import native  # noqa: E402


def _levels(size: int):
    rng = np.random.default_rng(0)
    base = rng.integers(60, 220, (size // 64, size // 64, 3)).astype(np.uint8)
    lv0 = np.kron(base, np.ones((64, 64, 1), np.uint8))  # smooth-ish content
    lv1 = lv0[::4, ::4].copy()
    return [lv0, lv1]


def make_slide(path: str, size: int, tile: int, quality: int = 85) -> None:
    native.write_tiff_pyramid(path, _levels(size), tile=tile,
                              compression="jpeg", quality=quality)


def make_raw_slide(path: str, size: int) -> None:
    """The same two levels as :func:`make_slide`, uncompressed WSIRAW."""
    native.write_wsiraw(path, _levels(size))


def _read_batch(slide, coords, tile: int) -> np.ndarray:
    """The eval path's batch: ``read_regions`` where the reader has it
    (TIFF, one threaded call), else one ``read_region`` per tile."""
    if hasattr(slide, "read_regions"):
        return slide.read_regions(0, coords, tile, tile)
    return np.stack([slide.read_region(0, int(x), int(y), tile, tile)
                     for x, y in coords])


def bench(slide, tile: int, n: int, threads):
    """(train-path tiles/s, eval-path tiles/s); ``threads`` sets
    STAINLIB_TIFF_THREADS (None: the reader's own count)."""
    if threads is not None:
        os.environ["STAINLIB_TIFF_THREADS"] = str(threads)
    W, H = slide.level_size(0)
    # Random sampling (train path).
    t0 = time.perf_counter()
    tiles, _ = slide.sample_tiles(0, tile, n, seed=7, white_mean_max=255.0,
                                  stddev_min=0.0)
    dt_sample = time.perf_counter() - t0
    assert tiles.shape == (n, tile, tile, 3)
    # Batched grid decode (eval path).
    rng = np.random.default_rng(1)
    coords = np.stack([
        rng.integers(0, W - tile, n), rng.integers(0, H - tile, n)
    ], -1).astype(np.int64)
    t0 = time.perf_counter()
    out = _read_batch(slide, coords, tile)
    dt_eval = time.perf_counter() - t0
    assert out.shape == (n, tile, tile, 3)
    return n / dt_sample, n / dt_eval


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--tile", type=int, default=256)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--threads", default="1,2,4,8",
                    help="STAINLIB_TIFF_THREADS sweep (svs only)")
    ap.add_argument("--container", choices=("svs", "wsiraw"), default="svs")
    args = ap.parse_args(argv)

    svs = args.container == "svs"
    if svs and not native.tiff_native_available():
        print(json.dumps({"error": "libtiff toolchain missing"}))
        return 1

    with tempfile.TemporaryDirectory() as td:
        if svs:
            path = os.path.join(td, "bench.svs")
            make_slide(path, args.size, args.tile)
            slide = native.TiffSlide(path)
            sweep = [int(t) for t in args.threads.split(",")]
        else:
            path = os.path.join(td, "bench.wsiraw")
            make_raw_slide(path, args.size)
            slide = native.RawSlide(path)
            assert slide.native, "the native WSIRAW reader did not load"
            sweep = [None]  # tilereader.cpp: every hardware thread
            print(f"wsiraw: one row at the reader's own thread count "
                  f"({os.cpu_count()}); --threads applies to TIFF only",
                  flush=True)
        rows = {}
        try:
            bench(slide, args.tile, 16, sweep[0])  # warm the codec/pool
            for th in sweep:
                s_tps, e_tps = bench(slide, args.tile, args.n, th)
                key = th if th is not None else os.cpu_count()
                rows[key] = {"sample_tiles_tps": round(s_tps, 1),
                             "read_regions_tps": round(e_tps, 1)}
                print(f"threads={key}: sample {s_tps:.0f} tiles/s, "
                      f"eval-batch {e_tps:.0f} tiles/s", flush=True)
        finally:
            slide.close()
            os.environ.pop("STAINLIB_TIFF_THREADS", None)
    size_key = "jpeg_size" if svs else "raw_size"
    print(json.dumps({"host_cores": os.cpu_count(), "tile": args.tile,
                      size_key: args.size, "container": args.container,
                      "by_threads": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
