"""Balanced batch generators for classifier training.

Port of the JAX package's ``data/generators.py`` (numpy only), the
host-side re-design of the DANN patch generators
(``dlmodels/stain_adversarial_learning/utils/utils_patches.py``):
``simplePatchGeneratorMitosis`` (``:54-140``) yields infinite balanced
positive/negative batches; ``simplePatchGeneratorDomains`` (``:223-305``)
balances over acquisition domains parsed from filenames;
``extract_patches`` (``:353-400``) provides strided sliding-window views;
``filter_white_patches`` (``:402-408``) drops background patches.

The reference couples globbing, PNG decoding, augmentation and balancing
into one object; here the generators are pure index-samplers over
memory-resident arrays (or a loader callback), so the device-side
augmentation (:mod:`stainlib_tpu_torch.augmentation`) runs batched, and
the host does nothing but gather + copy. ``predict_fn`` may return a numpy
array or a tensor on any device.
"""

from __future__ import annotations

import re
from typing import Callable, Iterator, Optional

import numpy as np


def _host(x) -> np.ndarray:
    """A prediction as a numpy array (a tensor is moved to the host)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def parse_domain_id(filename: str, pattern: str = r"(\d+)") -> int:
    """Domain id from a patch filename — the reference derives the domain
    (slide/scanner id) from the name (``utils_patches.py:241-258``)."""
    m = re.search(pattern, filename)
    if m is None:
        raise ValueError(f"no domain id in {filename!r}")
    return int(m.group(1))


def balanced_batches(
    images: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    groups: Optional[np.ndarray] = None,
    seed: int = 0,
    augment_fn: Optional[Callable] = None,
) -> Iterator:
    """Infinite balanced batches.

    With ``groups=None``: half the batch from each of the two classes in
    ``labels`` (mitosis generator contract). With ``groups``: equal samples
    per group (domain generator contract); ``labels`` still supplies the
    task labels. Yields (images, labels, groups) numpy triples; if
    ``augment_fn(batch, rng) -> batch`` is given it runs per batch.
    """
    images = np.asarray(images)
    labels = np.asarray(labels)
    if groups is None:
        groups = labels
    groups = np.asarray(groups)
    uniq = np.unique(groups)
    per = batch_size // len(uniq)
    assert per > 0, (batch_size, len(uniq))
    idx_by_group = {g: np.where(groups == g)[0] for g in uniq}
    rng = np.random.default_rng(seed)

    while True:
        picks = np.concatenate(
            [rng.choice(idx_by_group[g], per, replace=True) for g in uniq]
        )
        rng.shuffle(picks)
        batch = images[picks]
        if augment_fn is not None:
            batch = augment_fn(batch, rng)
        yield batch, labels[picks], groups[picks]


def extract_patches(image: np.ndarray, patch: int, stride: int) -> np.ndarray:
    """Strided sliding-window patches of (H, W, C) -> (N, patch, patch, C).

    The stride-tricks view of ``extract_patches`` (``utils_patches.py:
    353-400``), as a copy (device transfer needs contiguous memory anyway).
    """
    h, w, c = image.shape
    rows = (h - patch) // stride + 1
    cols = (w - patch) // stride + 1
    s0, s1, s2 = image.strides
    view = np.lib.stride_tricks.as_strided(
        image,
        shape=(rows, cols, patch, patch, c),
        strides=(s0 * stride, s1 * stride, s0, s1, s2),
        writeable=False,
    )
    return np.ascontiguousarray(view.reshape(-1, patch, patch, c))


def filter_white_patches(patches: np.ndarray, mean_threshold: float = 230.0):
    """Keep patches whose mean intensity is below the threshold
    (``utils_patches.py:402-408``). Returns (kept_patches, kept_indices)."""
    means = patches.reshape(len(patches), -1).mean(axis=1)
    keep = np.where(means < mean_threshold)[0]
    return patches[keep], keep


def sliding_window_scores(predict_fn, image: np.ndarray, patch: int,
                          stride: int, batch_size: int = 256) -> np.ndarray:
    """Dense sliding-window inference heatmap (``utils_patches.py:477-511``):
    scores every window with ``predict_fn`` and reshapes to the window grid."""
    patches = extract_patches(image, patch, stride)
    h, w, _ = image.shape
    rows = (h - patch) // stride + 1
    cols = (w - patch) // stride + 1
    scores = np.empty((len(patches),), np.float32)
    for i in range(0, len(patches), batch_size):
        chunk = patches[i : i + batch_size]
        pad = batch_size - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        s = _host(predict_fn(chunk))[:, 1]
        scores[i : i + batch_size] = s[: len(patches[i : i + batch_size])]
    return scores.reshape(rows, cols)


def mine_hard_negatives(predict_fn, patches, labels, k: int,
                        batch_size: int = 256):
    """Top-k highest-scoring NEGATIVE patches — the hard-negative-mining
    step of the TUPAC dataset-construction notebook
    (``TUPAC_Initial_Classifier_HardNegSampling.ipynb``): score all
    negatives with the current model, return the most confident false
    positives to add to the training set.

    Returns (indices_into_patches, scores) sorted by descending score.
    """
    patches = np.asarray(patches)
    labels = np.asarray(labels)
    neg_idx = np.where(labels == 0)[0]
    scores = np.empty(len(neg_idx), np.float32)
    for i in range(0, len(neg_idx), batch_size):
        chunk = patches[neg_idx[i : i + batch_size]]
        pad = batch_size - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        s = _host(predict_fn(chunk))[:, 1]
        scores[i : i + batch_size] = s[: len(neg_idx[i : i + batch_size])]
    order = np.argsort(-scores)[:k]
    return neg_idx[order], scores[order]


def save_heatmap(path: str, scores: np.ndarray):
    """Save a sliding-window score grid as a PNG heatmap
    (``utils_patches.py:459-474``'s heatmap dump)."""
    from PIL import Image  # imported here: PIL is optional

    s = np.asarray(scores, np.float64)
    s = (s - s.min()) / max(s.max() - s.min(), 1e-12)
    # Simple blue->red colormap.
    rgb = np.stack([s, 0.2 * (1 - np.abs(2 * s - 1)), 1.0 - s], -1)
    img = (rgb * 255).astype(np.uint8)
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(img).save(path)
    return path
