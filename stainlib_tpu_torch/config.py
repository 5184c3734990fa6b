"""Unified configuration for the whole framework.

Port of the JAX package's ``config.py``: the same dataclass tree with the
same defaults, field by field, built on the port's ``SamplerConfig``,
``DannConfig`` and ``FlowConfig``.

The reference mixes three config styles — keyword defaults in the core
library (``stain_utils.py:32,69``; ``vahadane_stain_extractor.py:19``), a
constants module for DANN (``stain_adversarial_learning/utils/config.py:
1-16``) and a ~70-flag argparse surface for the flow trainer
(``train_img_horo.py:43-141``). Here one dataclass tree carries the union of
the knobs that matter (SURVEY.md section 5 'Config / flag system'), with the
sub-configs reused directly by the corresponding trainers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from stainlib_tpu_torch.data.wsi import SamplerConfig
from stainlib_tpu_torch.models.train_dann import DannConfig
from stainlib_tpu_torch.models.train_flow import FlowConfig


@dataclasses.dataclass
class StainConfig:
    """Core stain-processing knobs (reference defaults cited per field)."""

    luminosity_threshold: float = 0.8  # stain_utils.py:32
    luminosity_percentile: float = 95.0  # stain_utils.py:54
    brightness_percentile: float = 90.0  # stain_utils.py:193
    lasso_regularizer: float = 0.01  # stain_utils.py:69
    vahadane_regularizer: float = 0.1  # vahadane_stain_extractor.py:19
    vahadane_iters: int = 12  # fixed-iteration BCD from the Macenko warm start
    angular_percentile: float = 99.0  # macenko_stain_extractor.py:7
    concentration_percentile: float = 99.0  # normalizer.py:36


@dataclasses.dataclass
class AugmentConfig:
    """Augmenter ranges (``augmenter.py:346-372,403-448``)."""

    hed_thresh: float = 0.1  # light preset; 0.03 lighter, 1.0 strong
    hed_cutoff: Tuple[float, float] = (0.05, 0.95)
    stain_sigma1: float = 0.2
    stain_sigma2: float = 0.2
    augment_background: bool = False
    hsv_hue: float = 0.05
    hsv_sat: float = 0.1
    hsv_val: float = 0.1


@dataclasses.dataclass
class MeshConfig:
    """Device-mesh shape (``parallel.mesh.make_mesh``); the first axis is
    the slowest (across hosts) one."""

    data: Optional[int] = None  # None -> all ranks
    tiles: int = 1


@dataclasses.dataclass
class Config:
    stain: StainConfig = dataclasses.field(default_factory=StainConfig)
    augment: AugmentConfig = dataclasses.field(default_factory=AugmentConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    dann: DannConfig = dataclasses.field(default_factory=DannConfig)
    flow: FlowConfig = dataclasses.field(default_factory=FlowConfig)
