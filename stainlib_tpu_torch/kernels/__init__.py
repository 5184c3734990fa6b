from stainlib_tpu_torch.kernels.fused_stain import (
    from_planar,
    fused_normalize,
    fused_normalize_planar,
    fused_normalize_planar_ref,
    to_planar,
)
from stainlib_tpu_torch.kernels.macenko_fused import (
    macenko_normalize,
    macenko_normalize_planar,
    macenko_normalize_planar_ref,
)
from stainlib_tpu_torch.kernels.vahadane_fused import (
    vahadane_normalize,
    vahadane_normalize_planar,
    vahadane_normalize_planar_2k,
    vahadane_normalize_planar_ref,
    vahadane_stain_matrix_planar,
    vahadane_stain_matrix_planar_ref,
)

__all__ = [
    "to_planar",
    "from_planar",
    "fused_normalize",
    "fused_normalize_planar",
    "fused_normalize_planar_ref",
    "macenko_normalize",
    "macenko_normalize_planar",
    "macenko_normalize_planar_ref",
    "vahadane_normalize",
    "vahadane_normalize_planar",
    "vahadane_normalize_planar_2k",
    "vahadane_normalize_planar_ref",
    "vahadane_stain_matrix_planar",
    "vahadane_stain_matrix_planar_ref",
]
