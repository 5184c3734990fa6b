"""Compare the PyTorch/CUDA port's kernels in two source trees on one GPU.

    python scripts/torch_compare_trees.py OTHER_TREE

Runs this tree's and ``OTHER_TREE``'s ``stainlib_tpu_torch`` each in its
own process on the same inputs (synthetic H&E tiles from
``tests/synth.py`` and fixed target stain matrices, from a seed), saves
every kernel's output, then prints one line per kernel: how many output
values differ between the two trees and by how much, and, in each tree,
whether the kernel equals its plain PyTorch version on the card. The
kernels: all ten, K1, K2, K3, K4, K5, K6, K7, K8, K9 and K10 at 256 tiles
of 256x256, K3 and K7 on one 2048x2048 field, K4 also on that field's
256x256 grid subsample (the tiled route's shape), K6, K9 and K10 also on
one 256x256 tile and on 16 tiles of 512x512 (the batches their cluster
plans treat differently). Besides the counts it reports each kernel's
largest difference from its plain version (K10's budget is 1e-6). ``OTHER_TREE`` is a checkout of
another commit, e.g.
``git archive <commit> | tar -x -C .runs/parent``. Exits non-zero without
a CUDA device. The last line is a JSON object with the same figures.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 20261016
B, SIDE, FIELD = 256, 256, 2048
FAST = dict(fit_stride=2, n_bisect=10)
VFAST = dict(fit_stride=2, num_iters=8, n_bisect=10)
# Target stain rows and 99th-percentile concentrations: the order of
# magnitude of an H&E fit; fixed so both trees see the same numbers.
M_TGT = [[0.5626, 0.7201, 0.4062], [0.2159, 0.8012, 0.5581]]
MC_TGT = [1.9, 1.3]
# Reinhard's LAB target means and standard deviations, and the augment
# draws (alpha, beta per stain): fixed, of the size a fit and a draw give.
LAB_MEANS, LAB_STDS = [59.77, 22.49, -8.83], [24.57, 13.48, 6.01]
ALPHA, BETA = [1.1, 0.92], [0.05, -0.04]


def _synth():
    spec = importlib.util.spec_from_file_location(
        "stain_synth", ROOT / "tests" / "synth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dump(tree: Path, out: Path) -> None:
    """Every kernel's output, and its plain version's, in ``tree``."""
    sys.path.insert(0, str(tree))
    from stainlib_tpu_torch.kernels import fused_stain as fs
    from stainlib_tpu_torch.kernels import macenko_fused as mf
    from stainlib_tpu_torch.kernels import reinhard_fused as rf
    from stainlib_tpu_torch.kernels import vahadane_fused as vf

    assert Path(mf.__file__).resolve().is_relative_to(tree.resolve()), (
        mf.__file__, tree)
    dev = torch.device("cuda", 0)
    synth = _synth()
    batch = torch.from_numpy(synth.he_batch(B, SIDE, SIDE, seed=SEED)).to(dev)
    planar = fs.to_planar(batch).contiguous()
    field = torch.from_numpy(
        synth.he_batch(1, FIELD, FIELD, seed=SEED + 1)).to(dev)
    sub = fs.to_planar(field[:, ::8, ::8].contiguous()).contiguous()
    M = torch.tensor(M_TGT, device=dev)
    mc = torch.tensor(MC_TGT, device=dev)
    means = torch.tensor(LAB_MEANS, device=dev)
    stds = torch.tensor(LAB_STDS, device=dev)
    alpha = torch.tensor(ALPHA, device=dev).expand(B, 2)
    beta = torch.tensor(BETA, device=dev).expand(B, 2)
    m8_plain = vf.vahadane_stain_matrix_planar_ref(planar)
    one = batch[:1].contiguous()
    big = torch.from_numpy(synth.he_batch(16, 512, 512, seed=SEED + 2)).to(dev)
    big_planar = fs.to_planar(big).contiguous()
    m8_big = vf.vahadane_stain_matrix_planar_ref(big_planar)
    mc_src = (mc * 1.1).expand(B, 2).contiguous()

    def fit(fn, x):
        return torch.cat([y.reshape(x.shape[0], -1) for y in fn(x)], 1)
    cases = {
        "K1": (lambda: mf.macenko_normalize(batch, M, mc, **FAST),
               lambda: mf.macenko_normalize_ref(batch, M, mc, **FAST)),
        "K2": (lambda: vf.vahadane_normalize(batch, M, mc, **VFAST),
               lambda: vf.vahadane_normalize_ref(batch, M, mc, **VFAST)),
        "K8": (lambda: vf.vahadane_stain_matrix_planar(planar),
               lambda: m8_plain),
        "K9": (lambda: fs.fused_normalize_planar(planar, m8_plain, M, mc),
               lambda: fs.fused_normalize_planar_ref(planar, m8_plain, M,
                                                     mc)),
        "K9 B=1": (
            lambda: fs.fused_normalize_planar(planar[:1], m8_plain[:1], M,
                                              mc),
            lambda: fs.fused_normalize_planar_ref(planar[:1], m8_plain[:1],
                                                  M, mc)),
        "K9 B=16 512^2": (
            lambda: fs.fused_normalize_planar(big_planar, m8_big, M, mc),
            lambda: fs.fused_normalize_planar_ref(big_planar, m8_big, M,
                                                  mc)),
        "K3": (lambda: mf.normalize_with_matrix(field, M, mc * 1.1, M, mc),
               lambda: mf.normalize_with_matrix_ref(field, M, mc * 1.1, M,
                                                    mc)),
        "K3 B=256": (
            lambda: mf.normalize_with_matrix_planar(planar, m8_plain, mc_src,
                                                    M, mc),
            lambda: mf.normalize_with_matrix_planar_ref(planar, m8_plain,
                                                        mc_src, M, mc)),
        "K4": (lambda: fit(mf.macenko_fit_planar, planar),
               lambda: fit(mf.macenko_fit_planar_ref, planar)),
        "K4 subsample": (lambda: fit(mf.macenko_fit_planar, sub),
                         lambda: fit(mf.macenko_fit_planar_ref, sub)),
        "K5": (lambda: rf.reinhard_normalize(batch, means, stds),
               lambda: rf.reinhard_normalize_ref(batch, means, stds)),
        "K6": (lambda: mf.macenko_augment(batch, alpha, beta),
               lambda: mf.macenko_augment_ref(batch, alpha, beta)),
        "K6 B=1": (lambda: mf.macenko_augment(one, alpha[:1], beta[:1]),
                   lambda: mf.macenko_augment_ref(one, alpha[:1], beta[:1])),
        "K6 B=16 512^2": (
            lambda: mf.macenko_augment(big, alpha[:16], beta[:16]),
            lambda: mf.macenko_augment_ref(big, alpha[:16], beta[:16])),
        "K7": (lambda: mf.augment_with_matrix_planar(planar, M, alpha, beta),
               lambda: mf.augment_with_matrix_planar_ref(planar, M, alpha,
                                                         beta)),
        "K7 field": (
            lambda: mf.augment_with_matrix(field, M, alpha[:1], beta[:1]),
            lambda: mf.augment_with_matrix_ref(field, M, alpha[:1],
                                               beta[:1])),
        "K10": (lambda: mf.eigenplane(planar),
                lambda: mf.eigenplane_ref(planar)),
        "K10 B=1": (lambda: mf.eigenplane(planar[:1]),
                    lambda: mf.eigenplane_ref(planar[:1])),
        "K10 B=16 512^2": (lambda: mf.eigenplane(big_planar),
                           lambda: mf.eigenplane_ref(big_planar)),
    }
    res = {name: {"kernel": k().cpu(), "plain": p().cpu()}
           for name, (k, p) in cases.items()}
    torch.cuda.synchronize()
    torch.save(res, out)


def _diff(a, b):
    """(values that differ, max |difference|), NaN equal to NaN."""
    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = (a - b).abs().nan_to_num(0.0)
    return int((~same).sum()), float(d.max()) if d.numel() else 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--dump", nargs=2, metavar=("TREE", "FILE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_compare_trees: no CUDA device", file=sys.stderr)
        return 2
    if args.dump:
        dump(Path(args.dump[0]), Path(args.dump[1]))
        return 0
    trees = {"other": args.other.resolve(), "this": ROOT}
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, tree in trees.items():
            f = Path(tmp) / f"{label}.pt"
            subprocess.run([sys.executable, __file__, str(args.other),
                            "--dump", str(tree), str(f)], check=True,
                           cwd=tree)
            res[label] = torch.load(f)
    other, this = res["other"], res["this"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    summary = {"card": smi, "kernels": {}}
    for name in this:
        n, mx = _diff(this[name]["kernel"], other[name]["kernel"])
        n_this, mx_this = _diff(this[name]["kernel"], this[name]["plain"])
        n_other, _ = _diff(other[name]["kernel"], other[name]["plain"])
        total = this[name]["kernel"].numel()
        summary["kernels"][name] = dict(
            values=total, differ_between_trees=n, max_abs_diff=mx,
            this_vs_plain_differ=n_this, this_vs_plain_max=mx_this,
            other_vs_plain_differ=n_other)
        print(f"{name}: {n} of {total} values differ between the trees "
              f"(share {n / total:.3e}, max |diff| {mx:.6g}); kernel vs "
              f"plain differs at {n_this} (this tree, max |diff| "
              f"{mx_this:.6g}), {n_other} (other)", flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
