"""No module of the harness or the reference loads JAX or the JAX
package, and the reference loads nothing of the port: checked in a fresh
interpreter, by whole top-level module names."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark.tests._tiny import REPO

PROBE = """
import importlib, json, sys
for m in {mods!r}:
    importlib.import_module(m)
{extra}
print(json.dumps(sorted({{k.split('.')[0] for k in sys.modules}})))
"""


def _top_level(mods, extra=""):
    p = subprocess.run([sys.executable, "-c",
                        PROBE.format(mods=mods, extra=extra)], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_reference_imports_no_port_and_no_jax():
    top = _top_level(["benchmark.reference.ops",
                      "benchmark.reference.planar"])
    assert not top & {"jax", "jaxlib", "flax", "stainlib_tpu",
                      "stainlib_tpu_torch"}


def test_a_run_loads_no_jax():
    """A whole run of a cell on the CPU (the program's plain path) loads
    the port, and neither JAX nor the JAX package."""
    extra = """
from pathlib import Path
import tempfile
from benchmark import harness, calibrate
from benchmark.tests._tiny import tiny_root
root = tiny_root(Path(tempfile.mkdtemp()))
for cell in ("macenko-perslide-256", "vahadane-pertile-256"):
    harness.run_cell(cell, 3, 0.2, False, "cpu", root=root)
assert not harness.forbidden_modules()
"""
    top = _top_level(["benchmark.harness", "benchmark.calibrate",
                      "benchmark.trace", "benchmark.roofline",
                      "benchmark.tiles"], extra)
    assert "stainlib_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "stainlib_tpu"}
