"""Time the thread-block-cluster kernels K1, K2, K4, K6, K8, K9 and K10 at
every cluster size and over the batch.

    python scripts/torch_cluster_sweep.py [--kernels K6 K9 ...]

On one GPU, at each cluster size G in 1, 2, 4, 8, 16, forced through
``cluster_plan``'s ``g``:

* K1 (``macenko_normalize``, ``fit_stride=2, n_bisect=10``), K8
  (``vahadane_stain_matrix_planar``, ``fit_stride=1, num_iters=12,
  n_bisect=14``) and K2 (``vahadane_normalize``, ``fit_stride=2,
  num_iters=8, n_bisect=10``) on 1, 4, 16, 64, 96, 128 and 256 tiles of
  256x256 and on 16 tiles of 512x512, K1 and K8 also on 1, 4 and 128 tiles
  of 512x512 and on 256 tiles of 128x128 and of 128x192 (K1 there at
  ``fit_stride=1, n_bisect=14``, the drop-in API's knobs below 256x256):
  the shapes ``cluster_plan``'s batch rule for K1 and K8 is taken from;
* K6 (``macenko_augment``, the default knobs) and K9
  (``fused_normalize_planar``, given the plain K8's per-tile rows), whose
  sample is the whole tile, on the same 256x256 and 512x512 batches;
* K10 (``eigenplane``, which stages nothing; its G forced through
  ``eigenplane_plan``'s ``g``) on the same 256x256 batches and on 1, 4 and
  16 tiles of 512x512: the shapes ``eigenplane_plan``'s rule is taken
  from;
* K4 (``macenko_fit_planar``) on the 256x256 grid subsample of a 2048x2048
  field;
* K2 and K4 on tiles whose sample no cluster's shared memory holds (16
  tiles of 1024x1024 at ``fit_stride=1``, staged in device memory);
* K1, K6, K8 and K9 once more with the stage forced into device memory
  where the plan would keep it in shared memory (two blocks then share an
  SM whatever the slice).

Every variant is held to its plain PyTorch version (identical bytes,
identical floats) and timed twice, in order and then in reverse order: the
kernel alone (``torch.profiler`` device time per call over 15 calls, the
L2 flushed before each, ``chip_smoke.device_ms``) and with CUDA events
(the median of 15 calls, ``chip_smoke.time_ms``). Prints one line per
variant with the plan's choice, then a table of the times alone (the
lower of the two readings; one row per shape, one column per G and
staging, the plan's choice, its time over the row's best, the bytes of its
device-memory stage and the peak of device memory allocated during one
call over what was allocated before it), the card's name and power limit, and as the last line a JSON object with the same
figures. ``--kernels`` restricts the run to the shapes of the kernels it
names (default: all seven). Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(1, str(ROOT))  # after this script's own directory
from chip_smoke import REPS, device_ms, nvidia_smi, time_ms  # noqa: E402
from torch_compare_trees import (  # noqa: E402
    ALPHA, B, BETA, FAST, FIELD, M_TGT, MC_TGT, SEED, SIDE, VFAST, _synth)

B_BIG, BIG = 16, 1024
BATCHES = (1, 4, 16, 64, 96, 128, 256)
BATCHES_LARGE, SIDE_LARGE = (1, 4, 16, 128), 512
# Below 256x256 the drop-in API fits on every pixel: (height, width).
SMALL = ((128, 128), (128, 192))
DEVICE_NAME = {"K1": "macenko_apply_kernel", "K2": "vahadane_normalize_kernel",
               "K4": "macenko_fit_kernel", "K8": "vahadane_dict_kernel",
               "K6": "macenko_augment_kernel", "K9": "fused_normalize_kernel",
               "K10": "eigenplane_kernel"}
BATCHED = ("K1", "K6", "K8", "K9")  # the kernels with the batch rule


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", nargs="+", default=list(DEVICE_NAME),
                    choices=list(DEVICE_NAME))
    args = ap.parse_args()
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
    large = torch.from_numpy(synth.he_batch(
        BATCHES_LARGE[-1], SIDE_LARGE, SIDE_LARGE, seed=SEED + 3)).to(dev)
    big = torch.from_numpy(synth.he_batch(B_BIG, BIG, BIG,
                                          seed=SEED + 2)).to(dev)
    field = torch.from_numpy(synth.he_batch(1, FIELD, FIELD, seed=SEED + 1))
    s = extractive.tiled_est_stride(FIELD, FIELD)
    sub = fs.to_planar(field[:, ::s, ::s].contiguous().to(dev)).contiguous()
    big_planar = fs.to_planar(big).contiguous()
    M = torch.tensor(M_TGT, device=dev)
    mc = torch.tensor(MC_TGT, device=dev)

    def sample(x, kw):
        nblk, blk, _ = mf._sample_args(x.shape[1] * x.shape[2],
                                       kw.get("fit_stride", 1))
        return nblk * blk

    def k1(x, kw):
        want = mf.macenko_normalize_ref(x, M, mc, **kw)
        return (sample(x, kw), "K1", x.shape[0],
                lambda g: mf._launch(x, False, M, mc, g=g, **kw),
                lambda got: torch.equal(got, want))

    def k2(x, kw):
        want = vf.vahadane_normalize_ref(x, M, mc, **kw)
        return (sample(x, kw), "K2", x.shape[0],
                lambda g: vf._launch(x, False, M, mc, g=g, **kw),
                lambda got: torch.equal(got, want))

    def k8(x):
        planar = fs.to_planar(x).contiguous()
        want = vf._dict_plane_ref(planar)
        return (sample(x, {}), "K8", x.shape[0],
                lambda g: vf._dict_launch(planar, g=g),
                lambda got: torch.equal(got, want))

    def k6(x):
        al = torch.tensor(ALPHA, device=dev).repeat(x.shape[0], 1)
        be = torch.tensor(BETA, device=dev).repeat(x.shape[0], 1)
        want = mf.macenko_augment_ref(x, al, be)
        return (x.shape[1] * x.shape[2], "K6", x.shape[0],
                lambda g: mf._aug_launch(x, False, al, be, g=g),
                lambda got: torch.equal(got, want))

    def k9(x):
        planar = fs.to_planar(x).contiguous()
        rows = vf.vahadane_stain_matrix_planar_ref(planar)
        want = fs.fused_normalize_planar_ref(planar, rows, M, mc)
        return (x.shape[1] * x.shape[2], "K9", x.shape[0],
                lambda g: fs._launch(planar, True, rows, M, mc, g=g),
                lambda got: torch.equal(got, want))

    def k10(x):
        planar = fs.to_planar(x).contiguous()
        want = mf.eigenplane_ref(planar)
        return (x.shape[1] * x.shape[2], "K10", x.shape[0],
                lambda g: mf._eigen_launch(planar, g=g),
                lambda got: torch.equal(got, want))

    def k4(planar):
        want = mf.macenko_fit_planar_ref(planar)
        return (planar.shape[2] * planar.shape[3], "K4", planar.shape[0],
                lambda g: mf._fit_launch(planar, g=g),
                lambda got: all(torch.equal(a, b) for a, b in zip(got, want)))

    shapes = {}

    def add(label, kern, make, *case):
        """The case ``make(*case)`` under ``label``, for the kernels run."""
        if kern in args.kernels:
            shapes[label] = make(*case)

    tiles = [(f"B={b} {SIDE}^2", batch[:b].contiguous()) for b in BATCHES]
    tiles += [(f"B={b} {SIDE_LARGE}^2", large[:b].contiguous())
              for b in BATCHES_LARGE]
    for label, x in tiles:
        add(f"K1 {label} fs=2 nb=10", "K1", k1, x, FAST)
        add(f"K8 {label} fs=1 it=12 nb=14", "K8", k8, x)
        add(f"K6 {label} nb=14", "K6", k6, x)
        add(f"K9 {label}", "K9", k9, x)
        if x.shape[1] == SIDE or x.shape[0] <= 16:
            add(f"K10 {label}", "K10", k10, x)
        if x.shape[1] == SIDE or x.shape[0] == 16:
            add(f"K2 {label} fs=2 it=8 nb=10", "K2", k2, x, VFAST)
    for h, w in SMALL:
        small = batch[:, :h, :w].contiguous()
        add(f"K1 B={B} {h}x{w} fs=1 nb=14", "K1", k1, small, {})
        add(f"K8 B={B} {h}x{w} fs=1 it=12 nb=14", "K8", k8, small)
    add(f"K2 B={B_BIG} {BIG}^2 fs=1 it=12 nb=14", "K2", k2, big, {})
    add(f"K4 one {SIDE}^2 subsample", "K4", k4, sub)
    add(f"K4 B={B_BIG} {BIG}^2", "K4", k4, big_planar)

    # (shape, G, stage forced into device memory)
    cases = [(label, g, False) for label in shapes for g in mf.CLUSTER_SIZES]
    cases += [(label, g, True) for label, (n, kern, b, _, _) in shapes.items()
              if kern in BATCHED for g in mf.CLUSTER_SIZES
              if mf.cluster_plan(n, kern, g, b).smem]
    sms = mf.sm_count(dev)

    def plan_of(n, kern, b, g=None):
        """(G, stage) of the plan, forced to ``g`` where given: the stage
        ``s`` (shared memory), ``d`` (device memory), or ``""`` for K10,
        which stages nothing."""
        if kern == "K10":
            return mf.eigenplane_plan(b, n, sms, g), ""
        p = mf.cluster_plan(n, kern, g, b, sms)
        return p.g, "s" if p.smem else "d"

    def peak_bytes(run):
        """Device memory allocated at the peak of one ``run(None)`` (the
        plan's own choice) over what was allocated before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        run(None)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(dev) - before

    alone = {c: [] for c in cases}
    events = {c: [] for c in cases}
    smem_block = mf._SMEM_BLOCK
    for i, c in enumerate(cases + cases[::-1]):
        n, kern, b, run, same = shapes[c[0]]
        mf._SMEM_BLOCK = 0 if c[2] else smem_block  # no slice fits: scratch
        if i < len(cases):
            assert same(run(c[1])), f"{c} differs from plain"
        alone[c].append(device_ms(lambda: run(c[1]), DEVICE_NAME[kern]))
        events[c].append(time_ms(lambda: run(c[1])))
    mf._SMEM_BLOCK = smem_block
    smi = nvidia_smi()
    summary = {"card": smi, "sms": sms, "reps": REPS, "variants": []}
    memory = {}
    for label, (n, kern, b, run, _) in shapes.items():
        scratch = 0
        if kern != "K10":
            pick = mf.cluster_plan(n, kern, batch=b, sms=sms)
            if not pick.smem:
                scratch = b * pick.g * mf.STAGE_BYTES * pick.slice
        memory[label] = (scratch, peak_bytes(run))
    for label, g, forced in cases:
        n, kern, b = shapes[label][:3]
        stage = "d" if forced else plan_of(n, kern, b, g)[1]
        pick_g, pick_stage = plan_of(n, kern, b)
        where = {"s": "staged in shared memory",
                 "d": "staged in device memory", "": "no stage"}[stage]
        (da, db), (ea, eb) = alone[(label, g, forced)], events[(label, g,
                                                                forced)]
        fmt = "/".join("not measured" if d is None else f"{d:.4f}"
                       for d in (da, db))
        print(f"{label} at G={g} ({n} sample px, {where}): equal to plain; "
              f"alone {fmt} ms (profiler device time per call, {REPS} "
              f"calls); {ea:.3f}/{eb:.3f} ms by events (median of {REPS}); "
              f"in order then reversed; the plan picks G={pick_g}"
              f"{pick_stage}", flush=True)
        summary["variants"].append(dict(shape=label, g=g, stage=stage,
                                        plan_g=pick_g, plan_stage=pick_stage,
                                        alone_ms=[da, db], ms=[ea, eb],
                                        plan_scratch_bytes=memory[label][0],
                                        plan_peak_bytes=memory[label][1]))
    print_table(summary["variants"])
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    return 0


def print_table(variants) -> None:
    """One row per shape: the time alone (ms, the lower reading) at each G,
    staged in shared memory (``s``) or in device memory (``d``), or with no
    stage (K10), then the plan's choice, its time over the row's best, and
    the plan's device-memory stage and peak allocation during a call in
    MB."""
    order = [f"{g}{st}" for g in (1, 2, 4, 8, 16) for st in ("", "s", "d")]
    rows, picks, memory = {}, {}, {}
    for v in variants:
        read = [t for t in v["alone_ms"] if t is not None]
        if read:
            rows.setdefault(v["shape"], {})[f"{v['g']}{v['stage']}"] = min(
                read)
        picks[v["shape"]] = f"{v['plan_g']}{v['plan_stage']}"
        memory[v["shape"]] = (v["plan_scratch_bytes"], v["plan_peak_bytes"])
    cols = [c for c in order if any(c in row for row in rows.values())]
    print("| Shape, alone ms | " + " | ".join(cols)
          + " | plan | plan / best | stage MB | peak MB |")
    print("|---" * (len(cols) + 5) + "|")
    for shape, row in rows.items():
        pick = picks[shape]
        ratio = (f"{row[pick] / min(row.values()):.2f}" if pick in row
                 else "not measured")
        print(f"| {shape} | "
              + " | ".join(f"{row[c]:.4f}" if c in row else "" for c in cols)
              + f" | {pick} | {ratio} | {memory[shape][0] / 1e6:.1f} "
              f"| {memory[shape][1] / 1e6:.1f} |", flush=True)


if __name__ == "__main__":
    sys.exit(main())
