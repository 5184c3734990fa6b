"""Vahadane stain-matrix estimation by dictionary learning, batched.

Port of the JAX package's ``extraction/vahadane.py:21-72``, the batched
re-design of ``stainlib/extraction/vahadane_stain_extractor.py:16-43``
(A. Vahadane et al., 'Structure-Preserving Color Normalization and Sparse
Stain Separation for Histological Images'): tissue-masked OD -> sparse
non-negative dictionary learning (K=2, lambda=0.1), warm-started from the
Macenko estimate -> H-first ordering -> row normalization. An empty tissue
mask gives NaN rows.
"""

from __future__ import annotations

import torch

from stainlib_tpu_torch.extraction.macenko import stain_matrix_macenko_from_od
from stainlib_tpu_torch.ops.colorspace import rgb_to_od
from stainlib_tpu_torch.ops.dictlearn import _HE_INIT, fit_stain_dictionary
from stainlib_tpu_torch.ops.tissue import tissue_mask


def stain_matrix_vahadane(rgb, luminosity_threshold: float = 0.8,
                          regularizer: float = 0.1, num_iters: int = 12,
                          init="macenko"):
    """(..., H, W, 3) RGB in [0,255] -> (..., 2, 3) row-normalized stain
    matrix, H first (the ``dictionary[0,0] < dictionary[1,0]`` swap of
    ``vahadane_stain_extractor.py:40-41``).

    ``init``: a (..., 2, 3) start for the dictionary learner, or
    ``"macenko"`` (default) for the Macenko estimate, which lies close
    enough to the Vahadane optimum that 12 alternations do the work of the
    ~30 the fixed Ruifrok-Johnston prior (``init=None``) needs.
    """
    rgb = torch.as_tensor(rgb)
    tm = tissue_mask(rgb, luminosity_threshold)
    od = rgb_to_od(rgb)
    lead = od.shape[:-3]
    n_pix = od.shape[-3] * od.shape[-2]
    od = od.reshape(lead + (n_pix, 3))
    mask = tm.mask.reshape(lead + (n_pix,))

    if isinstance(init, str) and init == "macenko":
        mac = stain_matrix_macenko_from_od(od, mask.to(torch.float32))
        # Degenerate tiles (empty or near-empty mask) start from the prior;
        # their output is NaN-masked below anyway.
        prior = torch.as_tensor(_HE_INIT, device=od.device).expand(mac.shape)
        init = torch.where(torch.isnan(mac), prior, mac)

    D = fit_stain_dictionary(od, mask, regularizer=regularizer,
                             num_iters=num_iters, init=init)

    swap = D[..., 0, 0] < D[..., 1, 0]
    row0 = torch.where(swap[..., None], D[..., 1, :], D[..., 0, :])
    row1 = torch.where(swap[..., None], D[..., 0, :], D[..., 1, :])
    D = torch.stack([row0, row1], dim=-2)
    D = D / torch.clamp_min(torch.linalg.vector_norm(D, dim=-1, keepdim=True),
                            1e-12)
    return torch.where((tm.count > 0)[..., None, None], D, torch.nan)
