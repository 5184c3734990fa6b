"""A copy of the benchmark at test sizes: every traffic mix cut to a few
128x128 tiles, every target to 128x128, the rest of the files as they
are."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = dict(tile=128, batch=8, pool_batches=2, warm_batches=2,
            checked_batches=2)


def tiny_root(tmp: Path) -> Path:
    """``tmp`` made a checkout of the benchmark at test sizes."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (tmp / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(TINY, slides_per_batch=min(t["slides_per_batch"], 4))
        if "mosaic_tiles" in t:
            t["mosaic_tiles"] = 4
        f.write_text(json.dumps(t))
    for f in (tmp / "benchmark" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["target"]["side"] = 128
        f.write_text(json.dumps(c))
    return tmp
