"""Dataset preprocessing: array shards and WSIRAW pyramid construction.

Port of the JAX package's ``data/preprocessing.py`` (numpy only).

Parity with the reference's ``preprocessing/`` scripts
(``create_imagenet_benchmark_datasets.py:21-49`` image-folder -> .npy;
``convert_to_pth.py:1-8`` container conversion) plus the converter that
turns any level-0 RGB plane (e.g. decoded offline from an OpenSlide-readable
slide where that library exists) into the WSIRAW pyramid consumed by the
native tile reader.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from stainlib_tpu_torch.data.native import write_wsiraw


def images_to_npy_shards(images, out_dir: str, shard_size: int = 1024,
                         prefix: str = "shard") -> list[str]:
    """Stack uint8 images into .npy shards (the imagenet32/64 .npy layout of
    ``create_imagenet_benchmark_datasets.py``)."""
    os.makedirs(out_dir, exist_ok=True)
    images = np.asarray(images, np.uint8)
    paths = []
    for i in range(0, len(images), shard_size):
        p = os.path.join(out_dir, f"{prefix}_{i // shard_size:05d}.npy")
        np.save(p, images[i : i + shard_size])
        paths.append(p)
    return paths


def load_npy_shards(paths: Sequence[str]) -> np.ndarray:
    return np.concatenate([np.load(p) for p in paths])


def build_pyramid(level0: np.ndarray, n_levels: int = 4) -> list[np.ndarray]:
    """Mean-pooled 2x pyramid from a level-0 RGB uint8 plane."""
    levels = [np.ascontiguousarray(level0, dtype=np.uint8)]
    cur = level0.astype(np.uint16)
    for _ in range(n_levels - 1):
        h, w, _ = cur.shape
        h2, w2 = h // 2 * 2, w // 2 * 2
        c = cur[:h2, :w2]
        pooled = (
            c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2] + c[1::2, 1::2]
        ) // 4
        levels.append(pooled.astype(np.uint8))
        cur = pooled
        if min(cur.shape[:2]) < 2:
            break
    return levels


def array_to_wsiraw(path: str, level0: np.ndarray, n_levels: int = 4) -> str:
    """Level-0 plane -> WSIRAW pyramid file for the native reader."""
    write_wsiraw(path, build_pyramid(level0, n_levels))
    return path
