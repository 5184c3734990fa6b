from stainlib_tpu_torch.ops.colorspace import (
    hsd_to_rgb,
    lab_luminance,
    lab_to_rgb,
    rgb_to_hsd,
    rgb_to_lab,
    rgb_to_od,
    to_uint8,
)
from stainlib_tpu_torch.ops.delta_e import (
    delta_e76,
    delta_e_report,
    mean_delta_e,
)
from stainlib_tpu_torch.ops.dictlearn import fit_stain_dictionary
from stainlib_tpu_torch.ops.lasso import (
    get_concentrations,
    nonneg_lasso_fista,
    nonneg_lasso_k2,
)
from stainlib_tpu_torch.ops.linalg3 import eigh3x3
from stainlib_tpu_torch.ops.percentile import (
    masked_mean,
    masked_percentile,
    mean_std,
    percentile,
)
from stainlib_tpu_torch.ops.tissue import (
    TissueMask,
    luminosity_standardize,
    standardize_brightness,
    tissue_mask,
)
