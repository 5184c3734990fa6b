"""Run one cell of the benchmark once on the card and print its result.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the program (``stainlib_tpu_torch``). The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``checks``: each number compared beside its limit, which also end
standard error. Without a CUDA card, with fewer cards than the cell asks
for, or if JAX or the JAX package was loaded, it exits non-zero and prints
no result; it never falls back to the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    marks = {"imports_s": time.perf_counter() - T_START}

    cell = harness.find_cell(harness.load_spec(), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only and "
              "does not fall back to the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell asks for {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              t_start=T_START, marks=marks)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark may load neither JAX "
              "nor the JAX package", file=sys.stderr)
        return 3
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
