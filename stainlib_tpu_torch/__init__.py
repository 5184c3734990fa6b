"""stainlib_tpu_torch — the PyTorch/CUDA port of the JAX package beside it.

Same module paths and function names as the JAX package, which stays the
reference every module here is tested against. It covers the Macenko,
Vahadane and Reinhard normalize paths and stain augmentation: the
functional ops, Macenko and Vahadane extraction (with the dictionary
learner), extractive fit/transform with the tiled route for large fields,
Reinhard fit/transform, the augmentation package (HED, grayscale, HSV,
RGB and geometric jitter, stain-concentration augmentation), the drop-in
object API, the fused kernels (``kernels/macenko_fused.py``,
``kernels/vahadane_fused.py``, ``kernels/fused_stain.py``,
``kernels/reinhard_fused.py``), hand-written in CUDA C++ for Hopper
(``kernels/csrc/``) and built with ``nvcc`` at first use, and whole-slide
deployment: the native slide readers, the WSI sampler and the device
prefetch ring (``data/``, the readers built with ``g++`` at first use) and
``normalization/slide.py``'s ``normalize_slide``; and the distributed
layer (``parallel/``: process groups, named device meshes, collectives and
the sharded stain paths on ``torch.distributed``).

Importing the package imports ``torch`` only: never jax, never
the JAX package, and it builds nothing.

Precision: importing the package sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``, so every float32 contraction
on the card runs in full float32: the counterpart of
``precision=lax.Precision.HIGHEST`` in the JAX package's
``ops/colorspace.py:31-37``.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from stainlib_tpu_torch.api import (  # noqa: E402
    ExtractiveStainNormalizer,
    LuminosityStandardizer,
    LuminosityThresholdTissueLocator,
    MacenkoStainExtractor,
    ReinhardStainNormalizer,
    VahadaneStainExtractor,
    get_concentrations,
)
from stainlib_tpu_torch.augmentation import (  # noqa: E402
    GrayscaleAugmentor,
    HedColorAugmenter,
    HedColorAugmenter1,
    HedLightColorAugmenter,
    HedLighterColorAugmenter,
    HedStrongColorAugmenter,
    StainAugmentor,
)
from stainlib_tpu_torch.exceptions import (  # noqa: E402
    DigitalPathologyAugmentationError,
    DigitalPathologyError,
    InvalidRangeError,
    TissueMaskException,
)

__version__ = "0.1.0"

__all__ = [
    "HedColorAugmenter",
    "HedColorAugmenter1",
    "HedLighterColorAugmenter",
    "HedLightColorAugmenter",
    "HedStrongColorAugmenter",
    "GrayscaleAugmentor",
    "StainAugmentor",
    "ExtractiveStainNormalizer",
    "ReinhardStainNormalizer",
    "MacenkoStainExtractor",
    "VahadaneStainExtractor",
    "LuminosityStandardizer",
    "LuminosityThresholdTissueLocator",
    "get_concentrations",
    "DigitalPathologyError",
    "DigitalPathologyAugmentationError",
    "InvalidRangeError",
    "TissueMaskException",
]
