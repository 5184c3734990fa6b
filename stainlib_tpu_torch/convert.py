"""Carry fitted state from the JAX package into the port.

The counterpart of the JAX package's ``normalization/extractive.py:35-39``
(``ExtractiveParams``, the fitted target of ``normalizer.py:27-37``):
given the JAX fit as numpy arrays, build the port's params, so both
packages can transform against the same target state.
"""

from __future__ import annotations

import numpy as np
import torch

from stainlib_tpu_torch.normalization.extractive import ExtractiveParams


def params_from_jax(stain_matrix_target, max_c_target, device) -> ExtractiveParams:
    """``np.asarray`` of a JAX ``ExtractiveParams``' fields -> the port's
    ``ExtractiveParams`` on ``device``, float32."""
    def to(x):
        return torch.tensor(np.array(x, np.float32), device=device)

    return ExtractiveParams(stain_matrix_target=to(stain_matrix_target),
                            max_c_target=to(max_c_target))
