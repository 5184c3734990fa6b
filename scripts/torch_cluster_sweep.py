"""Time the thread-block-cluster kernels K2 and K4 at every cluster size.

    python scripts/torch_cluster_sweep.py

On one GPU, times K2 (``vahadane_normalize``, 256 tiles of 256x256 at
``fit_stride=2, num_iters=8, n_bisect=10``) and K4 (``macenko_fit_planar``
on the 256x256 grid subsample of a 2048x2048 field) at each cluster size G
in 1, 2, 4, 8, 16, forced through ``cluster_plan``'s ``g``, and both on
tiles whose sample no cluster's shared memory holds (16 tiles of 1024x1024
at ``fit_stride=1``, staged in device memory). Every variant is held to
its plain PyTorch version (identical bytes, identical floats) and timed
with CUDA events, the median of 15 calls (``chip_smoke.time_ms``), in
order and then in reverse order. Prints one line per variant with the
plan's choice, then the card's name and power limit, and as the last line
a JSON object with the same figures. Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(1, str(ROOT))  # after this script's own directory
from chip_smoke import REPS, nvidia_smi, time_ms  # noqa: E402
from torch_compare_trees import (  # noqa: E402
    B, FIELD, M_TGT, MC_TGT, SEED, SIDE, VFAST, _synth)

B_BIG, BIG = 16, 1024


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_cluster_sweep: no CUDA device", file=sys.stderr)
        return 2
    from stainlib_tpu_torch.kernels import fused_stain as fs
    from stainlib_tpu_torch.kernels import macenko_fused as mf
    from stainlib_tpu_torch.kernels import vahadane_fused as vf
    from stainlib_tpu_torch.normalization import extractive

    dev = torch.device("cuda", 0)
    synth = _synth()
    batch = torch.from_numpy(synth.he_batch(B, SIDE, SIDE, seed=SEED)).to(dev)
    big = torch.from_numpy(synth.he_batch(B_BIG, BIG, BIG,
                                          seed=SEED + 2)).to(dev)
    field = torch.from_numpy(synth.he_batch(1, FIELD, FIELD, seed=SEED + 1))
    s = extractive.tiled_est_stride(FIELD, FIELD)
    sub = fs.to_planar(field[:, ::s, ::s].contiguous().to(dev)).contiguous()
    big_planar = fs.to_planar(big).contiguous()
    M = torch.tensor(M_TGT, device=dev)
    mc = torch.tensor(MC_TGT, device=dev)

    def k2(x, kw):
        nblk, blk, _ = mf._sample_args(x.shape[1] * x.shape[2],
                                       kw.get("fit_stride", 1))
        want = vf.vahadane_normalize_ref(x, M, mc, **kw)
        return (nblk * blk, "K2", lambda g: vf._launch(x, False, M, mc, g=g,
                                                        **kw),
                lambda got: torch.equal(got, want))

    def k4(planar):
        want = mf.macenko_fit_planar_ref(planar)
        return (planar.shape[2] * planar.shape[3], "K4",
                lambda g: mf._fit_launch(planar, g=g),
                lambda got: all(torch.equal(a, b) for a, b in zip(got, want)))

    shapes = {
        f"K2 B={B} {SIDE}^2 fs=2 it=8 nb=10": k2(batch, VFAST),
        f"K2 B={B_BIG} {BIG}^2 fs=1 it=12 nb=14": k2(big, {}),
        f"K4 one {SIDE}^2 subsample": k4(sub),
        f"K4 B={B_BIG} {BIG}^2": k4(big_planar),
    }
    cases = [(label, g) for label in shapes for g in mf.CLUSTER_SIZES]
    times = {c: [] for c in cases}
    for c in cases + cases[::-1]:
        n, kern, run, same = shapes[c[0]]
        assert same(run(c[1])), f"{c} differs from plain"
        times[c].append(time_ms(lambda: run(c[1])))
    smi = nvidia_smi()
    summary = {"card": smi, "reps": REPS, "variants": []}
    for label, g in cases:
        n, kern = shapes[label][:2]
        p, pick = mf.cluster_plan(n, kern, g), mf.cluster_plan(n, kern)
        where = (f"{p.smem} B shared per block" if p.smem else
                 "staged in device memory")
        ta, tb = times[(label, g)]
        print(f"{label} at G={g} ({n} sample px, {where}): equal to plain; "
              f"{ta:.3f}/{tb:.3f} ms (median of {REPS} CUDA-event runs, "
              f"in order then reversed); the plan picks G={pick.g}",
              flush=True)
        summary["variants"].append(dict(shape=label, g=g, smem=p.smem,
                                        plan_g=pick.g, ms=[ta, tb]))
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
