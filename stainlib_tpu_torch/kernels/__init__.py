from stainlib_tpu_torch.kernels.fused_stain import from_planar, to_planar
from stainlib_tpu_torch.kernels.macenko_fused import (
    macenko_normalize,
    macenko_normalize_planar,
    macenko_normalize_planar_ref,
)

__all__ = [
    "to_planar",
    "from_planar",
    "macenko_normalize",
    "macenko_normalize_planar",
    "macenko_normalize_planar_ref",
]
