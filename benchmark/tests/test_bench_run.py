"""run.py on a machine without a card, and in a checkout that holds only
the benchmark: a clear message, a non-zero exit, no result, no fallback to
the CPU."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

from benchmark.tests._tiny import REPO


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "macenko-pertile-256", "--seed", str(2 ** 31 + 9), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(
            env or {})))


def test_no_card_no_result():
    p = _run(REPO)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr
    assert "CPU" in p.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
