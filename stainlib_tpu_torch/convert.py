"""Carry fitted state from the JAX package into the port.

The counterparts of the JAX package's fitted targets: ``ExtractiveParams``
(``normalization/extractive.py:35-39``, ``normalizer.py:27-37``) and
``ReinhardParams`` (``normalization/reinhard.py:24-28``,
``normalizer.py:64-68``). Given the JAX fit as numpy arrays, build the
port's params, so both packages can transform against the same target.
"""

from __future__ import annotations

import numpy as np
import torch

from stainlib_tpu_torch.normalization.extractive import ExtractiveParams
from stainlib_tpu_torch.normalization.reinhard import ReinhardParams


def _to(x, device):
    return torch.tensor(np.array(x, np.float32), device=device)


def params_from_jax(stain_matrix_target, max_c_target, device) -> ExtractiveParams:
    """``np.asarray`` of a JAX ``ExtractiveParams``' fields -> the port's
    ``ExtractiveParams`` on ``device``, float32."""
    return ExtractiveParams(stain_matrix_target=_to(stain_matrix_target, device),
                            max_c_target=_to(max_c_target, device))


def reinhard_params_from_jax(means, stds, device) -> ReinhardParams:
    """``np.asarray`` of a JAX ``ReinhardParams``' ``means`` and ``stds`` ->
    the port's ``ReinhardParams`` on ``device``, float32."""
    return ReinhardParams(means=_to(means, device), stds=_to(stds, device))
