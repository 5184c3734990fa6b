"""Dataset manifests: filename lists and deterministic splits.

Port of the JAX package's ``data/manifests.py`` (numpy only).

Parity with the reference's ``datasets_utils/{tupac,tcga_tmaz}/*.txt``
train/val/test/external filename manifests (SURVEY.md section 2.3): plain
newline-separated lists, plus helpers to build splits deterministically and
to resolve them against a root directory.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np


def write_manifest(path: str, names: Sequence[str]) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for n in names:
            f.write(f"{n}\n")
    return path


def read_manifest(path: str, root: str | None = None) -> List[str]:
    with open(path) as f:
        names = [ln.strip() for ln in f if ln.strip()]
    if root is not None:
        names = [os.path.join(root, n) for n in names]
    return names


def split_manifest(names: Sequence[str], fractions: Dict[str, float],
                   seed: int = 0) -> Dict[str, List[str]]:
    """Deterministic shuffled split; fraction keys -> name lists.

    Fractions must sum to <= 1; the remainder (if any) goes to 'rest'.
    """
    total = sum(fractions.values())
    if total > 1.0 + 1e-9:
        raise ValueError(f"fractions sum to more than 1: {fractions}")
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(names))
    out: Dict[str, List[str]] = {}
    start = 0
    for key, frac in fractions.items():
        k = int(round(frac * len(names)))
        out[key] = [names[i] for i in order[start : start + k]]
        start += k
    if start < len(names):
        out["rest"] = [names[i] for i in order[start:]]
    return out


def write_split_manifests(out_dir: str, splits: Dict[str, List[str]],
                          prefix: str = "") -> Dict[str, str]:
    """One ``{prefix}{split}_filenames.txt`` per split — the reference's
    manifest naming convention."""
    return {
        key: write_manifest(
            os.path.join(out_dir, f"{prefix}{key}_filenames.txt"), names
        )
        for key, names in splits.items()
    }
