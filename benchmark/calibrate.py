"""The readings that a cell's limits are set from, in one process on the
card: the program's sound runs over many seeds (the lower readings), the
control over a few (the upper readings), and the planted faults.

    python benchmark/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--fault-seeds 11] [--seconds 2] \
        [--out chiprun_out/calib/<name>.json]

Each reading is a short run of the cell through ``harness.run_cell`` at
the cell's own sizes and load, so the numbers compared are those of a
benchmark run. The control is the plain reference put in the program's
place, computed a step below the configuration's stated precision: its
per-pixel intermediates (optical densities, the lasso's concentrations,
the reconstruction's exponent and ``exp``) rounded through bfloat16 and
its float32 contractions in TF32. The faults wrap the program's entry: the
batch returned unchanged; half of the batch left out (returned as it came);
one byte of the output altered. The benchmark's own runs run none of this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def tf32():
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def control(meth):
    """The reference, a step below the stated precision, as a program."""
    import torch

    def make(cfg, traffic, target, mosaic):
        with tf32():
            ref = meth.reference(cfg, traffic, target, mosaic,
                                 low=torch.bfloat16)

        def call(b):
            with tf32():
                return ref.call(b)

        return ref._replace(call=call)

    return make


def fault(meth, kind: str):
    """The port with one fault planted in its entry."""

    def make(cfg, traffic, target, mosaic):
        prog = meth.program(cfg, traffic, target, mosaic)

        def unchanged(b):
            return b.clone()

        def half(b):
            h = b.shape[0] // 2
            out = b.clone()
            out[:h] = prog.call(b[:h].contiguous())
            return out

        def byte(b):
            out = prog.call(b)
            out[0, 0, 0, 0] ^= 0x80
            return out

        return prog._replace(call={"unchanged": unchanged, "half": half,
                                   "byte": byte}[kind])

    return make


FAULTS = ("unchanged", "half", "byte")


def readings(name: str, seeds, control_seeds, fault_seeds, seconds: float,
             device) -> dict:
    from benchmark import harness

    meth = harness.method(harness.find_cell(harness.load_spec(), name).cfg)
    out = {"workload": name, "program": [], "control": [], "faults": []}

    def one(kind, seed, program=None):
        t = time.perf_counter()
        r = harness.run_cell(name, seed, seconds, False, device,
                             program=program)
        row = {"kind": kind, "seed": seed, "correct": r["correct"],
               "checks": {k: (c["value"] if isinstance(c, dict) else c)
                          for k, c in r["checks"].items()},
               "metrics": {k: m["value"] for k, m in r["metrics"].items()},
               "seconds": time.perf_counter() - t}
        print(json.dumps(row), flush=True)
        return row

    for s in seeds:
        out["program"].append(one("program", s))
    for s in control_seeds:
        out["control"].append(one("control", s, control(meth)))
    for s in fault_seeds:
        for kind in FAULTS:
            out["faults"].append(one(kind, s, fault(meth, kind)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    res = readings(args.workload, ints(args.seeds), ints(args.control_seeds),
                   ints(args.fault_seeds), args.seconds,
                   torch.device("cuda", 0))
    if args.out:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
