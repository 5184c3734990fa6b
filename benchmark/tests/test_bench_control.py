"""The comparison that decides ``correct``, driven through a whole run
with the timed path replaced: the port passes; the control (the reference
a step below float32) and each fault a cell can have fail. At test sizes;
``calibrate.py`` reads the same on the card at the cells' own sizes."""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests._tiny import tiny_root

CELLS = ["macenko-pertile-256", "vahadane-pertile-256",
         "macenko-perslide-256", "macenko-pertile-512"]

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _run(root, cell, program=None, seed=2 ** 31 + 17):
    """A run long enough for the plain versions on a loaded CPU to finish
    a few batches in the window."""
    r = harness.run_cell(cell, seed, 1.5, False, "cpu", root=root,
                         program=program)
    assert r["checks"]["checked_batches"] >= 1
    return r


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_is_correct(root, cell):
    r = _run(root, cell)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(root, cell):
    meth = harness.method(harness.find_cell(harness.load_spec(root), cell,
                                            root).cfg, root)
    r = _run(root, cell, calibrate.control(meth))
    assert not r["correct"]
    over = [k for k, c in r["checks"].items() if isinstance(c, dict)
            and c["value"] > c["limit"]]
    assert "out_share_ne" in over and "target_M" in over


@pytest.mark.parametrize("fault", calibrate.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_fails(root, cell, fault):
    meth = harness.method(harness.find_cell(harness.load_spec(root), cell,
                                            root).cfg, root)
    r = _run(root, cell, calibrate.fault(meth, fault))
    assert not r["correct"]
    assert r["checks"]["out_max_u8"]["value"] > r["checks"][
        "out_max_u8"]["limit"]


def test_a_check_without_a_limit_fails():
    ok, checks = harness.judge({"out_max_u8": 0.0, "new": 0.0},
                               {"out_max_u8": 1})
    assert not ok and checks["new"]["limit"] is None


def test_nan_fails():
    assert not harness.judge({"target_M": float("nan")},
                             {"target_M": 1e-5})[0]
