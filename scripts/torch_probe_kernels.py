#!/usr/bin/env python
"""Probe grid of the port's fused estimation kernels on the card.

The twin of ``scripts/probe_kernels.py``: the throughput of Macenko and
Vahadane kernel variants (bisection depth nb, estimation stride fs, BCD
iterations it, one Vahadane kernel K2 against two, K8 then K9), and for
each variant its fidelity, max |diff| in uint8 steps and the share of bytes
off by more than 1, against the port's functional path on the same tiles.

    python scripts/torch_probe_kernels.py                  # the default grid
    python scripts/torch_probe_kernels.py --only vahadane-roofline

Families (``--only``): ``macenko`` (256^2 at nb 14, 12, 10 and fs/nb),
``macenko512`` (max(batch/4, 8) tiles of 512^2, counted in 256^2-equivalent
tiles), ``vahadane`` (two kernels against one at it 12, 10, 8 and fs/it)
and ``vahadane-roofline`` (not in the default grid: the BCD slope over it,
nb at fs=2 it=8, the fs=4 estimation floor, Macenko of the same structure
without BCD, and the fixed-matrix apply K9 as the reconstruction floor).
The JAX grid's TPU-only axes (lane candidates ``n_cands``, tile interleave
``T``) have no counterpart: an entry that differed only in them appears
once. The cluster size G is ``scripts/torch_cluster_sweep.py``'s.

Tiles/s is ``--batch`` over the median step of a dependent chain of
``--iters`` steps (``torch_validate_gpu.chain_ms``: CUDA events on the card,
the host clock on the CPU). The JSON goes to ``--out`` and to stdout.
``--device cpu`` runs the kernels' plain versions; without it a host with
no CUDA device raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_validate_gpu import ROOT, chain_ms, he_batch, u8_diff  # noqa: E402

FAMILIES = ("macenko", "macenko512", "vahadane", "vahadane-roofline")


def grid(only):
    """[(name, route, input, knobs)]: route is the kernel entry
    (``macenko`` K1, ``vahadane`` K2, ``vahadane-2k`` K8 then K9,
    ``fixed`` K9 on the target's matrix), input ``256`` or ``512``."""
    out = []
    if only in (None, "macenko"):
        out += [(f"macenko 256 nb={nb}", "macenko", "256", dict(n_bisect=nb))
                for nb in (14, 12, 10)]
        out += [(f"macenko 256 fs={fs} nb={nb}", "macenko", "256",
                 dict(fit_stride=fs, n_bisect=nb))
                for fs, nb in ((2, 14), (2, 10), (4, 14))]
    if only in (None, "macenko512"):
        out.append(("macenko 512", "macenko", "512", {}))
    if only in (None, "vahadane"):
        out.append(("vahadane 256 two-kernel (r3)", "vahadane-2k", "256", {}))
        out += [(f"vahadane 256 single-kernel it={it}", "vahadane", "256",
                 dict(num_iters=it)) for it in (12, 10, 8)]
        out += [(f"vahadane 256 single-kernel fs={fs} it={it}", "vahadane",
                 "256", dict(fit_stride=fs, num_iters=it))
                for fs, it in ((2, 12), (2, 8), (4, 12))]
    if only == "vahadane-roofline":
        out += [(f"vahadane fs=2 it={it}", "vahadane", "256",
                 dict(fit_stride=2, num_iters=it)) for it in (2, 4, 8, 12)]
        out += [(f"vahadane fs=2 it={it} nb={nb}", "vahadane", "256",
                 dict(fit_stride=2, num_iters=it, n_bisect=nb))
                for it, nb in ((8, 10), (8, 14), (6, 10))]
        out += [("vahadane fs=4 it=8 (estimation floor probe)", "vahadane",
                 "256", dict(fit_stride=4, num_iters=8)),
                ("macenko fs=2 nb=10 (same-structure, no BCD)", "macenko",
                 "256", dict(fit_stride=2, n_bisect=10)),
                ("fixed-matrix apply (reconstruction floor)", "fixed", "256",
                 {})]
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--only", default=None, choices=FAMILIES)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", default=os.path.join(ROOT, ".runs",
                                                 "probe_kernels.json"))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def run(args) -> dict:
    sys.path.insert(0, ROOT)
    import torch

    from stainlib_tpu_torch.api import _device
    from stainlib_tpu_torch.kernels.fused_stain import (
        from_planar, fused_normalize_planar, to_planar)
    from stainlib_tpu_torch.kernels.macenko_fused import (
        macenko_normalize_planar)
    from stainlib_tpu_torch.kernels.vahadane_fused import (
        vahadane_normalize_planar, vahadane_normalize_planar_2k)
    from stainlib_tpu_torch.normalization import extractive
    from stainlib_tpu_torch.ops.lasso import get_concentrations
    from stainlib_tpu_torch.ops.percentile import percentile

    dev = _device(args.device)
    target = torch.from_numpy(he_batch(1, 128, 128, seed=1)[0]).to(dev)
    pm = extractive.fit(target, method="macenko")
    pv = extractive.fit(target, method="vahadane")
    M_fixed = pv.stain_matrix_target.expand(args.batch, 2, 3).contiguous()
    n512 = max(args.batch // 4, 8)
    inputs = {"256": (args.batch, 256, 3), "512": (n512, 512, 5)}

    def fixed_functional(rgb):
        """The functional route of K9 with the target's rows as every
        tile's source: exact lasso, each tile's 99th-percentile maxC."""
        C = get_concentrations(rgb, M_fixed, 0.01)
        max_c = percentile(C.reshape(len(rgb), -1, 2), 99.0, axis=-2)
        return extractive.transform_with_matrix(rgb, M_fixed, max_c, pv)

    routes = {
        "macenko": (lambda x, kw: macenko_normalize_planar(x, *pm, **kw),
                    lambda rgb: extractive.transform(pm, rgb, "macenko")),
        "vahadane": (lambda x, kw: vahadane_normalize_planar(x, *pv, **kw),
                     lambda rgb: extractive.transform(pv, rgb, "vahadane")),
        "vahadane-2k": (
            lambda x, kw: vahadane_normalize_planar_2k(x, *pv, **kw),
            lambda rgb: extractive.transform(pv, rgb, "vahadane")),
        "fixed": (lambda x, kw: fused_normalize_planar(x, M_fixed, *pv),
                  fixed_functional),
    }
    tiles, functional = {}, {}
    entries = {}
    for name, route, key, knobs in grid(args.only):
        n, side, seed = inputs[key]
        if key not in tiles:
            tiles[key] = torch.from_numpy(
                he_batch(n, side, side, seed=seed)).to(dev)
        rgb = tiles[key]
        planar = to_planar(rgb).contiguous()
        kernel, func = routes[route]
        ref_key = "vahadane" if route == "vahadane-2k" else route
        if (ref_key, key) not in functional:
            functional[ref_key, key] = func(rgb)
        got = from_planar(kernel(planar, knobs), side, side)
        mx, frac = u8_diff(got, functional[ref_key, key])
        ms = chain_ms(lambda x, kw=knobs: kernel(x, kw), planar, args.iters)
        equiv = n * (side // 256) ** 2
        entries[name] = dict(tiles_per_s=equiv / ms * 1e3, ms_per_step=ms,
                             tiles_256=equiv, max_diff=mx, frac_gt1=frac)
        print(f"{name}: {equiv / ms * 1e3:.0f} tiles/s, max diff {mx}, "
              f"frac>1 {frac:.2e}", flush=True)
    results = dict(
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
        clock="CUDA events" if dev.type == "cuda" else "host clock",
        batch=args.batch, iters=args.iters, entries=entries)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    run(parse_args(sys.argv[1:]))
