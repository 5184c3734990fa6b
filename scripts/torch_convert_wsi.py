#!/usr/bin/env python
"""Convert whole-slide images between containers the framework can stream.

The PyTorch port's counterpart of ``scripts/convert_wsi.py``, on the
port's readers and writers (``stainlib_tpu_torch.data.native``) and its
``data.preprocessing.build_pyramid``: the same decoders in the same order,
the same synthesized levels, the same bytes out. It runs on the host
alone (no device). The reference reads .tif/.svs directly via
OpenSlide/pyvips (``dlmodels/color-information/data_utils.py:1``). This
framework streams tiled pyramidal TIFF (and .svs) natively through libtiff
(``data/native.py::TiffSlide``), so conversion is only needed for (a)
producing the mmap-fast WSIRAW container, the one a host without libtiff
streams, or (b) re-containerizing exotic formats that only OpenSlide can
decode (used when importable).

Examples:
    python scripts/torch_convert_wsi.py slide.svs out.wsiraw
    python scripts/torch_convert_wsi.py slide.png out.tif --compression jpeg
    python scripts/torch_convert_wsi.py slide.wsiraw out.wsiraw --min-dim 512
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from stainlib_tpu_torch.data import native  # noqa: E402
from stainlib_tpu_torch.data.preprocessing import build_pyramid  # noqa: E402


def _to_uint8(arr: np.ndarray) -> np.ndarray:
    """Normalize a decoded page to uint8 without wrapping.

    astype(np.uint8) on 16-bit scanner exports wraps modulo 256; rescale
    integer dtypes by their full range and floats by [0, 1] instead."""
    if arr.dtype == np.uint8:
        return arr
    if np.issubdtype(arr.dtype, np.unsignedinteger):
        scale = 255.0 / np.iinfo(arr.dtype).max
        return (arr.astype(np.float32) * scale + 0.5).astype(np.uint8)
    if np.issubdtype(arr.dtype, np.floating):
        # Scale convention is ambiguous for float pages. Treat as [0,255]
        # only when clearly above the [0,1] convention (cutoff 2.0, not
        # 1.0): a [0,1] page with a stray 1.x value clips instead of being
        # crushed to near-black, and only a float page that is BOTH
        # 255-scaled and near-black (max <= 2/255 brightness) — where the
        # two conventions are visually indistinguishable — misclassifies.
        if arr.max() > 2.0:
            return np.clip(arr + 0.5, 0, 255).astype(np.uint8)
        return np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    raise ValueError(f"unsupported page dtype {arr.dtype}")


def read_levels(path: str, min_dim: int):
    """Read source pyramid levels, synthesizing missing ones by 2x box
    downsampling until min(side) < ``min_dim``. Decode order of preference:
    OpenSlide (exotic vendor formats) > tifffile > native libtiff > PIL."""
    levels = []
    try:  # pragma: no cover - openslide not in this image
        import openslide

        slide = openslide.OpenSlide(path)
        for i, (w, h) in enumerate(slide.level_dimensions):
            region = slide.read_region((0, 0), i, (w, h))
            levels.append(np.asarray(region.convert("RGB")))
        slide.close()
    except Exception:
        pass
    if not levels:
        try:  # pragma: no cover - tifffile not in this image
            import tifffile

            with tifffile.TiffFile(path) as tf:
                for page in tf.pages:
                    arr = page.asarray()
                    if arr.ndim == 3 and arr.shape[-1] >= 3:
                        levels.append(_to_uint8(arr[..., :3]))
            # Drop associated images (.svs label/macro pages) whose aspect
            # ratio deviates >10% from the widest page — same rule as the
            # native reader (tiffreader.cpp tf_open).
            if levels:
                base = max(levels, key=lambda a: a.shape[1])
                aspect0 = base.shape[1] / base.shape[0]
                levels = [a for a in levels
                          if 0.9 * aspect0 <= a.shape[1] / a.shape[0]
                          <= 1.1 * aspect0]
        except Exception:
            levels = []
    if not levels:
        try:
            slide = native.open_slide(path)
            for i in range(slide.num_levels):
                w, h = slide.level_size(i)
                levels.append(slide.read_region(i, 0, 0, w, h))
            slide.close()
        except Exception:
            pass
    if not levels:
        try:
            from PIL import Image

            with Image.open(path) as im:
                levels.append(np.asarray(im.convert("RGB")))
        except Exception as e:
            raise ValueError(
                f"cannot decode {path!r}: no available decoder could read "
                "it (tried OpenSlide, tifffile, native libtiff, PIL). "
                "OpenSlide-only containers (.mrxs, .ndpi, DICOM-WSI) "
                "require openslide-python; install it and re-run this "
                "converter to produce a .wsiraw/.tif the framework "
                "streams natively."
            ) from e

    levels.sort(key=lambda a: -a.shape[1])
    while min(levels[-1].shape[:2]) >= 2 * min_dim:
        # One 2x mean-pool step, shared with array_to_wsiraw's pyramid, so
        # converter- and preprocessing-built levels agree.
        levels.append(build_pyramid(levels[-1], 2)[1])
    return levels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("src", help="input slide (.svs/.tif/.wsiraw/any image)")
    ap.add_argument("dst", help="output path: .wsiraw or .tif/.tiff")
    ap.add_argument("--min-dim", type=int, default=256,
                    help="synthesize pyramid levels down to this size")
    ap.add_argument("--tile", type=int, default=256,
                    help="tile size for TIFF output")
    ap.add_argument("--compression", default="jpeg",
                    choices=sorted(native.TIFF_COMPRESSION),
                    help="TIFF output compression")
    ap.add_argument("--quality", type=int, default=90,
                    help="JPEG quality for TIFF output")
    args = ap.parse_args(argv)

    levels = read_levels(args.src, args.min_dim)
    for i, lv in enumerate(levels):
        print(f"level {i}: {lv.shape[1]}x{lv.shape[0]}", flush=True)

    if args.dst.lower().endswith((".tif", ".tiff", ".svs")):
        native.write_tiff_pyramid(args.dst, levels, tile=args.tile,
                                  compression=args.compression,
                                  quality=args.quality)
    elif args.dst.lower().endswith(".wsiraw"):
        native.write_wsiraw(args.dst, levels)
    else:
        ap.error("dst must end in .wsiraw, .tif, .tiff or .svs")
    print(f"wrote {args.dst} ({os.path.getsize(args.dst)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
