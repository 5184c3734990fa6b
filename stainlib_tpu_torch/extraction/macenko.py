"""Macenko stain-matrix estimation, batched.

Port of the JAX package's ``extraction/macenko.py:29-107``, itself the
batched re-design of ``stainlib/extraction/macenko_stain_extractor.py:5-44``
(Macenko et al., 'A method for normalizing histology slides for
quantitative analysis'):
tissue-masked OD covariance -> closed-form 3x3 eigenvectors -> angular
percentiles -> two extreme stain vectors -> H-first ordering -> row
normalization. An empty tissue mask gives NaN rows.
"""

from __future__ import annotations

import torch

from stainlib_tpu_torch.ops.colorspace import rgb_to_od
from stainlib_tpu_torch.ops.fdiv import f64, sum3
from stainlib_tpu_torch.ops.linalg3 import eigh3x3_f64
from stainlib_tpu_torch.ops.percentile import masked_percentile
from stainlib_tpu_torch.ops.tissue import tissue_mask


def stain_matrix_macenko(rgb, luminosity_threshold: float = 0.8,
                         angular_percentile: float = 99.0):
    """(..., H, W, 3) RGB in [0,255] -> (..., 2, 3) row-normalized stain
    matrix, Haematoxylin first (``macenko_stain_extractor.py:38-43``)."""
    rgb = torch.as_tensor(rgb)
    mask = tissue_mask(rgb, luminosity_threshold).mask
    od = rgb_to_od(rgb)
    lead = od.shape[:-3]
    n_pix = od.shape[-3] * od.shape[-2]
    od = od.reshape(lead + (n_pix, 3))
    m = mask.reshape(lead + (n_pix,)).to(torch.float32)
    return stain_matrix_macenko_from_od(od, m, angular_percentile)


def stain_matrix_macenko_from_od(od, m, angular_percentile: float = 99.0):
    """Macenko estimation from flattened OD (..., N, 3) and float tissue
    weights (..., N)."""
    # Weighted covariance over tissue pixels, N-1 like np.cov
    # (macenko_stain_extractor.py:22). The two pixel contractions
    # accumulate in float64: a float32 GEMM over 65k pixels (torch's CPU
    # einsum) loses ~6e-5 of the covariance, which moves the stain
    # vectors by ~5e-5 at 256^2.
    n = m.sum(-1)
    safe_n = torch.clamp_min(n, 1.0)
    mean = (torch.einsum("...n,...nc->...c", m.double(), od.double())
            .float() / safe_n[..., None])
    centered = od - mean[..., None, :]
    diff = centered * m[..., None]
    cov = torch.einsum("...nc,...nd->...cd", diff.double(),
                       centered.double()).float()
    cov = cov / torch.clamp_min(n - 1.0, 1.0)[..., None, None]

    # Top-2 eigenvectors, red component non-negative
    # (macenko_stain_extractor.py:24-27). The float64 solve: the card and
    # the CPU then agree on every bit of V.
    _, V = eigh3x3_f64(cov)
    V2 = V[..., :, [2, 1]]
    V2 = V2 * torch.where(V2[..., 0:1, :] < 0.0, -1.0, 1.0)

    That = torch.einsum("...nc,...ck->...nk", od, V2)
    phi = f64(torch.atan2, That[..., 1], That[..., 0])
    min_phi, max_phi = masked_percentile(
        phi, m > 0.0,
        torch.tensor([100.0 - angular_percentile, angular_percentile],
                     dtype=torch.float32, device=od.device))

    # V2 @ (cos, sin), in float64 transcendentals and a fixed order, so the
    # card rounds as the CPU does.
    v1 = (V2[..., 0] * f64(torch.cos, min_phi)[..., None]
          + V2[..., 1] * f64(torch.sin, min_phi)[..., None])
    v2 = (V2[..., 0] * f64(torch.cos, max_phi)[..., None]
          + V2[..., 1] * f64(torch.sin, max_phi)[..., None])

    # H first: the row with the larger red OD (macenko_stain_extractor.py:40-43).
    first = v1[..., 0] > v2[..., 0]
    h = torch.where(first[..., None], v1, v2)
    e = torch.where(first[..., None], v2, v1)
    HE = torch.stack([h, e], dim=-2)
    HE = HE / torch.sqrt(sum3(HE * HE))[..., None]
    return torch.where((n > 0.0)[..., None, None], HE, torch.nan)
