"""Exponential moving average of parameters.

Port of the JAX package's ``utils/ema.py``: the reference's
``utils.ExponentialMovingAverage``, applied after each optimizer step and
optionally swapped in at validation (``train_img_horo.py:366,594,668-669``).
Pure functions over a pytree (nested dicts) of tensors; nothing is changed
in place.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_map


class EmaState(NamedTuple):
    decay: float
    params: Any  # the shadow pytree


def ema_init(params, decay: float = 0.999) -> EmaState:
    return EmaState(decay=float(decay),
                    params=tree_map(lambda p: p.detach().clone(), params))


def ema_update(state: EmaState, params) -> EmaState:
    """shadow <- decay * shadow + (1 - decay) * params, with ``decay`` and
    ``1 - decay`` rounded in float32 as the JAX package rounds them."""
    d = np.float32(state.decay)
    keep, take = float(d), float(np.float32(1.0) - d)
    with torch.no_grad():
        new = tree_map(lambda s, p: s * keep + take * p, state.params,
                       params)
    return EmaState(decay=state.decay, params=new)


def ema_swap(state: EmaState, params):
    """Return (ema_params, live_params) for an eval-time swap-in/out."""
    return state.params, params
