#!/usr/bin/env python
"""Reproduce torch.profiler dropping device records after unprofiled time,
beside ``utils.profiling.trace``, which keeps them.

    python3 scripts/torch_trace_loss_repro.py [--cycles 16]

Each cycle runs 4 s of matmuls that nobody profiles, sleeps 5 s, then
traces nine launches of one torch kernel (``x.add_(1)``) and a
synchronize: in a plain CPU+CUDA ``torch.profiler`` session on even
cycles, through ``profiling.trace`` on odd ones. It prints one JSON line
per cycle: the process's age in seconds, the kind of
session and the device kernels it recorded (of 9; ``"raised"`` where
``trace`` found a launch without its kernel). Nothing of the port's
kernels runs. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK_S, IDLE_S = 4.0, 5.0  # unprofiled matmuls, then idle, per cycle


def kernels_in(path) -> int:
    with open(path) as f:
        return sum(e.get("cat") == "kernel"
                   for e in json.load(f)["traceEvents"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cycles", type=int, default=16)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stainlib_tpu_torch.api import _device
    from stainlib_tpu_torch.utils import profiling

    dev = _device("cuda")
    x = torch.ones(1 << 20, device=dev)
    big = torch.randn(4096, 4096, device=dev)
    t0 = time.perf_counter()

    def block():
        for _ in range(9):
            x.add_(1)
        torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.cycles):
            start = time.perf_counter()
            while time.perf_counter() - start < WORK_S:
                big @ big
            torch.cuda.synchronize()
            time.sleep(IDLE_S)
            path = os.path.join(tmp, f"trace_{i}")
            if i % 2 == 0:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    block()
                prof.export_chrome_trace(path + ".json")
                kept = kernels_in(path + ".json")
            else:
                try:
                    with profiling.trace(path):
                        block()
                    (name,) = os.listdir(path)
                    kept = kernels_in(os.path.join(path, name))
                except RuntimeError:
                    kept = "raised"
            print(json.dumps(dict(
                cycle=i, age_s=round(time.perf_counter() - t0, 1),
                session="plain" if i % 2 == 0 else "trace",
                kernels=kept)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
