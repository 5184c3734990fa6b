"""Perceptual color difference (delta-E), the fidelity metric.

Port of the JAX package's ``ops/delta_e.py:16-30``: CIE76 (Euclidean
CIELAB distance) on the port's OpenCV-parity LAB transform, and the mean
and percentile reductions the fidelity tests use.
"""

from __future__ import annotations

import torch

from stainlib_tpu_torch.ops.colorspace import rgb_to_lab
from stainlib_tpu_torch.ops.fdiv import sum3
from stainlib_tpu_torch.ops.percentile import percentile


def delta_e76(rgb_a, rgb_b):
    """Per-pixel CIE76 delta-E between two RGB [0,255] images or batches."""
    d = rgb_to_lab(rgb_a) - rgb_to_lab(rgb_b)
    return torch.sqrt(sum3(d * d))


def mean_delta_e(rgb_a, rgb_b):
    """Mean delta-E over all pixels (the delta-E < 1.0 acceptance
    statistic)."""
    return delta_e76(rgb_a, rgb_b).mean()


def delta_e_report(rgb_a, rgb_b):
    """(mean, p95, max) delta-E, the triple the fidelity harness logs."""
    de = delta_e76(rgb_a, rgb_b).reshape(-1)
    return de.mean(), percentile(de, 95.0), de.max()
