#!/usr/bin/env python
"""Normalize a whole slide with the PyTorch/CUDA port and write a pyramidal TIFF.

The counterpart of ``scripts/normalize_wsi.py`` for ``stainlib_tpu_torch``:
the reference's deployment loop (``tester`` + per-patch normalization,
``dlmodels/color-information/data_utils.py:1``,
``stainlib/normalization/normalizer.py:39-50``) as one command: native
decode on host threads -> prefetch ring onto the card -> the fused CUDA
kernels -> tiled pyramidal TIFF out.

    python scripts/torch_normalize_wsi.py slide.svs out.svs --target target.png
    python scripts/torch_normalize_wsi.py slide.svs out.svs --method vahadane \
        --estimation tile   # the reference's per-patch re-estimation
    python scripts/torch_normalize_wsi.py slide.wsiraw out.tif --device cpu
    torchrun --nproc-per-node 4 scripts/torch_normalize_wsi.py slide.svs \
        out.svs --mesh 4   # tile batches sharded over 4 ranks

With no --target, a built-in synthetic H&E target is used (handy for smoke
runs; real use should pass a reference patch from the template center).
Writing the TIFF needs libtiff on the host. With ``--mesh N`` the tile
batches are sharded over a mesh of N ranks (``parallel.mesh.make_mesh``):
N processes under a launcher that sets torchrun's variables, or one
process for N=1; the first rank writes the output.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _default_target():
    """A deterministic synthetic H&E target patch (no dataset dependency)."""
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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="input slide (.svs/.tif/WSIRAW)")
    ap.add_argument("out", help="output pyramidal TIFF path")
    ap.add_argument("--target", default=None,
                    help="target image file (default: built-in synthetic)")
    ap.add_argument("--method", default="macenko",
                    choices=["macenko", "vahadane", "reinhard"])
    ap.add_argument("--estimation", default="slide",
                    choices=["slide", "tile"],
                    help="'slide': one stain estimate per slide (seam-free, "
                         "fastest); 'tile': reference per-patch semantics")
    ap.add_argument("--tile", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--level", type=int, default=0)
    ap.add_argument("--fit-tiles", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compression", default="jpeg",
                    choices=["none", "lzw", "jpeg", "deflate"])
    ap.add_argument("--quality", type=int, default=90)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fit and the tiles (cpu: the "
                         "functional path)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard tile batches over a mesh of N ranks "
                         "(scale-out deployment; batch must divide by N)")
    args = ap.parse_args(argv)

    from stainlib_tpu_torch.normalization.slide import normalize_slide

    mesh = None
    if args.mesh:
        from stainlib_tpu_torch.parallel.mesh import (
            initialize_distributed, make_mesh)

        if "WORLD_SIZE" in os.environ:  # under torchrun
            initialize_distributed(auto=True, device=args.device)
        mesh = make_mesh(args.mesh, device=args.device)

    target = args.target if args.target else _default_target()

    t0 = time.time()
    last = [0.0]

    def progress(done, total):
        now = time.time()
        if now - last[0] > 5.0 or done == total:
            last[0] = now
            print(f"  {done}/{total} batches ({100.0 * done / total:.0f}%)",
                  flush=True)

    info = normalize_slide(
        args.src, args.out, target, method=args.method,
        estimation=args.estimation, tile=args.tile, batch=args.batch,
        level=args.level, n_fit_tiles=args.fit_tiles, seed=args.seed,
        compression=args.compression, quality=args.quality,
        progress=progress, device=args.device, mesh=mesh)
    dt = time.time() - t0
    rate = info["tiles"] / dt if dt > 0 else float("inf")
    print(f"{info['width']}x{info['height']} ({info['tiles']} tiles, "
          f"{info['levels']} levels) -> {args.out}")
    print(f"method={info['method']} estimation={info['estimation']} "
          f"fused={info['fused']}  wall {dt:.1f}s  {rate:.1f} tiles/s "
          f"end-to-end (decode+normalize+encode)")
    print(info, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
