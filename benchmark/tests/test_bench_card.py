"""The benchmark on the card: one short run of each cell, traced and not,
correct, with every metric of the cell in its line. Needs an NVIDIA GPU:
``python -m pytest benchmark/tests -m cuda``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests._tiny import REPO

SPEC = harness.load_spec(REPO)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_a_short_run_is_correct(card, cell, trace):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        cell, "--seed", str(2 ** 31 + 101), "--seconds", "3",
                        "--trace", str(trace)], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    c = harness.find_cell(SPEC, cell, REPO)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(r["metrics"]) == want
    assert r["device"]["platform"] == "gpu"
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert r["metrics"]["kernel_roofline_pct"]["value"] <= 100.0
    assert p.stderr.strip().splitlines()[-1].startswith("correct ")
