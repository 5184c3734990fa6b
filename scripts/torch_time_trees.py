"""Time the PyTorch/CUDA port's public entry points in two source trees on
one GPU, in turns.

    python scripts/torch_time_trees.py OTHER_TREE

Runs ``OTHER_TREE``'s and this tree's ``stainlib_tpu_torch`` each in its
own process, in the order other, this, this, other, on the same inputs
(synthetic H&E images from ``tests/synth.py`` and fixed target
parameters, from a seed). Each process times, with CUDA events (the median
of 15 calls after a warm-up, ``chip_smoke.time_ms``), the calls a user
makes:

* ``macenko_normalize`` (kernel K1, ``fit_stride=2, n_bisect=10``, the
  drop-in API's knobs), ``vahadane_stain_matrix_planar`` (kernel K8),
  ``macenko_augment`` (kernel K6) and ``fused_normalize_planar`` (kernel
  K9) on 256 tiles of 256x256, on one such tile and on 16 tiles of
  512x512; each also as the kernel alone (``torch.profiler`` device time
  per call);
* ``vahadane_normalize`` (kernel K2) on 256 tiles of 256x256 at
  ``fit_stride=2, num_iters=8, n_bisect=10``, and ``macenko_fit_planar``
  (kernel K4) on the 256x256 grid subsample of a 2048x2048 field, the
  tiled route's shape; each also as the kernel alone;
* ``augment_with_matrix_planar`` (kernel K7) on the 256 tiles and
  ``augment_with_matrix`` on the field, ``normalize_with_matrix`` (K3) on
  the field and ``normalize_with_matrix_planar`` on the 256 tiles (per-tile
  source rows and maxC), ``eigenplane`` (K10) on the 256 tiles, on one
  256x256 tile and on 16 tiles of 512x512, and ``reinhard_normalize`` (K5)
  on the 256 tiles, on one 256x256 tile and on 16 tiles of 512x512; each
  also as the kernel alone;
* ``StainAugmentor("macenko").pop()`` on one 256x256 image, on the host
  clock with a synchronize (the median of 64 pops after a warm-up);
* the functional paths on the card: ``extractive.transform`` (Macenko) and
  ``reinhard.transform`` on the 256 tiles, the tiled route of the 2048x2048
  field (Macenko: K4 + K3; Vahadane: the functional estimate + K3), and
  ``stain_augment`` on that field (the functional estimate + K7);
* the torch-only augmenters on the 256 tiles: HED jitter (light, strong),
  grayscale, RGB and HSV jitter, the geometric warp.

Only public functions are called, so any tree whose entry points keep
these signatures can be timed. ``OTHER_TREE`` is a checkout of another
commit, e.g. ``git archive <commit> | tar -x -C .runs/parent``. Prints one
line per entry point (both readings of each tree), then the card's name
and power limit, and as the last line a JSON object with the same figures.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(1, str(ROOT))  # after this script's own directory
from chip_smoke import REPS, device_ms, nvidia_smi, pop_ms, time_ms  # noqa: E402
from torch_compare_trees import (  # noqa: E402
    ALPHA, B, BETA, FAST, FIELD, LAB_MEANS, LAB_STDS, M_TGT, MC_TGT, SEED,
    SIDE, VFAST, _synth)

GEO = dict(rotation_range=30.0, width_shift_range=0.1,
           height_shift_range=0.1, shear_range=10.0, zoom_range=0.2,
           channel_shift_range=5.0, horizontal_flip=True, vertical_flip=True)


def measure(tree: Path, out: Path) -> None:
    """Every entry point's time in ``tree``, as JSON into ``out``."""
    sys.path.insert(0, str(tree))
    from stainlib_tpu_torch.augmentation import functional as AF
    from stainlib_tpu_torch.augmentation import geometric as AG
    from stainlib_tpu_torch.augmentation import hsv as AH
    from stainlib_tpu_torch.kernels import fused_stain as fs
    from stainlib_tpu_torch import StainAugmentor
    from stainlib_tpu_torch.kernels import macenko_fused as mf
    from stainlib_tpu_torch.kernels import reinhard_fused as rf
    from stainlib_tpu_torch.kernels import vahadane_fused as vf
    from stainlib_tpu_torch.normalization import extractive, reinhard

    assert Path(mf.__file__).resolve().is_relative_to(tree.resolve()), (
        mf.__file__, tree)
    dev = torch.device("cuda", 0)
    synth = _synth()
    batch = torch.from_numpy(synth.he_batch(B, SIDE, SIDE, seed=SEED)).to(dev)
    field = torch.from_numpy(
        synth.he_batch(1, FIELD, FIELD, seed=SEED + 1)[0]).to(dev)
    s = extractive.tiled_est_stride(FIELD, FIELD)
    sub = fs.to_planar(field[None, ::s, ::s].contiguous()).contiguous()
    M = torch.tensor(M_TGT, device=dev)
    mc = torch.tensor(MC_TGT, device=dev)
    params = extractive.ExtractiveParams(M, mc)
    means = torch.tensor(LAB_MEANS, device=dev)
    stds = torch.tensor(LAB_STDS, device=dev)
    rparams = reinhard.ReinhardParams(means, stds)
    planar = fs.to_planar(batch).contiguous()
    alpha = torch.tensor(ALPHA, device=dev).repeat(B, 1)
    beta = torch.tensor(BETA, device=dev).repeat(B, 1)
    one = batch[:1].contiguous()
    big = torch.from_numpy(synth.he_batch(16, 512, 512, seed=SEED + 2)).to(dev)
    planar_one = planar[:1].contiguous()
    planar_big = fs.to_planar(big).contiguous()
    m_src = M.expand(B, 2, 3).contiguous()
    mc_src = (mc * 1.1).expand(B, 2).contiguous()

    def gen(k):
        return torch.Generator().manual_seed(SEED + k)

    cases = {
        f"K1 macenko_normalize B={B} {SIDE}^2 fs=2 nb=10":
            lambda: mf.macenko_normalize(batch, M, mc, **FAST),
        f"K1 macenko_normalize B=1 {SIDE}^2 fs=2 nb=10":
            lambda: mf.macenko_normalize(one, M, mc, **FAST),
        "K1 macenko_normalize B=16 512^2 fs=2 nb=10":
            lambda: mf.macenko_normalize(big, M, mc, **FAST),
        f"K8 vahadane_stain_matrix_planar B={B} {SIDE}^2 fs=1 it=12 nb=14":
            lambda: vf.vahadane_stain_matrix_planar(planar),
        f"K8 vahadane_stain_matrix_planar B=1 {SIDE}^2 fs=1 it=12 nb=14":
            lambda: vf.vahadane_stain_matrix_planar(planar_one),
        "K8 vahadane_stain_matrix_planar B=16 512^2 fs=1 it=12 nb=14":
            lambda: vf.vahadane_stain_matrix_planar(planar_big),
        f"K6 macenko_augment B={B} {SIDE}^2":
            lambda: mf.macenko_augment(batch, alpha, beta),
        f"K6 macenko_augment B=1 {SIDE}^2":
            lambda: mf.macenko_augment(one, alpha[:1], beta[:1]),
        "K6 macenko_augment B=16 512^2":
            lambda: mf.macenko_augment(big, alpha[:16], beta[:16]),
        f"K9 fused_normalize_planar B={B} {SIDE}^2":
            lambda: fs.fused_normalize_planar(planar, m_src, M, mc),
        f"K9 fused_normalize_planar B=1 {SIDE}^2":
            lambda: fs.fused_normalize_planar(planar_one, m_src[:1], M, mc),
        "K9 fused_normalize_planar B=16 512^2":
            lambda: fs.fused_normalize_planar(planar_big, m_src[:16], M, mc),
        f"K2 vahadane_normalize B={B} {SIDE}^2 fs=2 it=8 nb=10":
            lambda: vf.vahadane_normalize(batch, M, mc, **VFAST),
        f"K4 macenko_fit_planar one {SIDE}^2 subsample":
            lambda: mf.macenko_fit_planar(sub),
        f"K7 augment_with_matrix_planar B={B} {SIDE}^2":
            lambda: mf.augment_with_matrix_planar(planar, M, alpha, beta),
        f"K7 augment_with_matrix one {FIELD}^2 field":
            lambda: mf.augment_with_matrix(field[None], M, alpha[:1],
                                           beta[:1]),
        f"K3 normalize_with_matrix one {FIELD}^2 field":
            lambda: mf.normalize_with_matrix(field[None], M, mc * 1.1, M, mc),
        f"K3 normalize_with_matrix_planar B={B} {SIDE}^2":
            lambda: mf.normalize_with_matrix_planar(planar, m_src, mc_src, M,
                                                    mc),
        f"K10 eigenplane B={B} {SIDE}^2": lambda: mf.eigenplane(planar),
        f"K10 eigenplane B=1 {SIDE}^2": lambda: mf.eigenplane(planar_one),
        "K10 eigenplane B=16 512^2": lambda: mf.eigenplane(planar_big),
        f"K5 reinhard_normalize B={B} {SIDE}^2":
            lambda: rf.reinhard_normalize(batch, means, stds),
        f"K5 reinhard_normalize B=1 {SIDE}^2":
            lambda: rf.reinhard_normalize(one, means, stds),
        "K5 reinhard_normalize B=16 512^2":
            lambda: rf.reinhard_normalize(big, means, stds),
        f"functional Macenko extractive.transform B={B} {SIDE}^2":
            lambda: extractive.transform(params, batch),
        f"functional Reinhard reinhard.transform B={B} {SIDE}^2":
            lambda: reinhard.transform(rparams, batch),
        f"tiled route Macenko {FIELD}^2 (K4 + K3)":
            lambda: extractive.transform_tiled(params, field,
                                               method="macenko", est_stride=s),
        f"tiled route Vahadane {FIELD}^2 (functional estimate + K3)":
            lambda: extractive.transform_tiled(params, field,
                                               method="vahadane", est_stride=s),
        f"stain_augment macenko {FIELD}^2 (functional estimate + K7)":
            lambda: AF.stain_augment(field, gen(32), "macenko"),
    }
    for k, (label, fn) in enumerate(
            (("hed_jitter light", AF.hed_light),
             ("hed_jitter strong", AF.hed_strong),
             ("grayscale_augment", AF.grayscale_augment),
             ("rgb_jitter", AF.rgb_jitter), ("hsv_jitter", AH.hsv_jitter),
             ("random_geometric",
              lambda x, g: AG.random_geometric(x, g, **GEO)))):
        cases[f"{label} B={B} {SIDE}^2"] = (
            lambda fn=fn, k=k: fn(batch, gen(50 + k)))
    res = {label: time_ms(fn) for label, fn in cases.items()}
    alone = {"K1": "macenko_apply_kernel", "K8": "vahadane_dict_kernel",
             "K6": "macenko_augment_kernel", "K9": "fused_normalize_kernel",
             "K2": "vahadane_normalize_kernel", "K4": "macenko_fit_kernel",
             "K7": "augment_apply_kernel", "K3": "matrix_apply_kernel",
             "K5": "reinhard_kernel", "K10": "eigenplane_kernel"}
    for label, fn in list(cases.items()):
        k, _, rest = label.partition(" ")
        if k in alone:
            res[f"{k} alone, {rest.partition(' ')[2]}"] = device_ms(
                fn, alone[k])
    aug = StainAugmentor("macenko", seed=SEED, device=dev)
    aug.fit(batch[0].cpu().numpy())
    res[f"StainAugmentor.pop one {SIDE}^2 image, host clock"] = pop_ms(aug)
    out.write_text(json.dumps(res))


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--measure", nargs=2, metavar=("TREE", "FILE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_time_trees: no CUDA device", file=sys.stderr)
        return 2
    if args.measure:
        measure(Path(args.measure[0]), Path(args.measure[1]))
        return 0
    order = [("other", args.other.resolve()), ("this", ROOT),
             ("this", ROOT), ("other", args.other.resolve())]
    runs = {"other": [], "this": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, tree) in enumerate(order):
            f = Path(tmp) / f"{i}.json"
            subprocess.run([sys.executable, __file__, str(args.other),
                            "--measure", str(tree), str(f)], check=True,
                            cwd=tree)
            runs[label].append(json.loads(f.read_text()))
    smi = nvidia_smi()
    summary = {"card": smi, "reps": REPS, "order": "other, this, this, "
               "other", "ms": {}}
    for name in runs["this"][0]:
        this = [r[name] for r in runs["this"]]
        other = [r.get(name) for r in runs["other"]]
        summary["ms"][name] = {"this": this, "other": other}
        print(f"{name}: this tree {' / '.join(map(fmt, this))} ms, other "
              f"{' / '.join(map(fmt, other))} ms", flush=True)
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
