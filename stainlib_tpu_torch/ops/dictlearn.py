"""Sparse non-negative dictionary learning for Vahadane stain estimation.

Port of the JAX package's ``ops/dictlearn.py:37-100``, which replaces the
reference's ``spams.trainDL(X=OD.T, K=2, lambda1, mode=2, modeD=0,
posAlpha=True, posD=True)`` (``stainlib/extraction/
vahadane_stain_extractor.py:35-36``) with a fixed-iteration batch
alternating minimization:

  * sparse-code step: the exact closed-form non-negative lasso
    (:func:`stainlib_tpu_torch.ops.lasso.nonneg_lasso_k2`) over every pixel;
  * dictionary step: block coordinate descent on the two stain rows with
    SPAMS' constraint set (non-negative entries, unit L2 ball), from the
    masked sufficient statistics ``C = A^T W A`` and ``B = A^T W X``, so
    the tissue mask enters as weights instead of a gather.

A deterministic start (Ruifrok-Johnston H&E rows, or a caller's matrix)
and a fixed iteration count give the same matrix on every run.
"""

from __future__ import annotations

import numpy as np
import torch

from stainlib_tpu_torch.ops.lasso import nonneg_lasso_k2

# Ruifrok-Johnston H & E optical-density directions (row-normalized): the
# published prior, used only as a deterministic starting point.
_HE_INIT = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]],
                    dtype=np.float32)
_HE_INIT /= np.linalg.norm(_HE_INIT, axis=1, keepdims=True)


def fit_stain_dictionary(od, mask, regularizer: float = 0.1,
                         num_iters: int = 30, init=None):
    """Learn the 2x3 stain dictionary from masked OD pixels.

    ``od``: (..., N, 3) optical densities; ``mask``: (..., N) tissue mask
    (weights); ``init``: optional (..., 2, 3) start, by default the
    Ruifrok-Johnston prior. Returns the (..., 2, 3) dictionary, rows
    non-negative and inside the unit ball; H-first ordering and the final
    row normalization are the caller's (the extractor's).
    """
    od = torch.as_tensor(od).to(torch.float32)
    w = torch.as_tensor(mask, device=od.device).to(torch.float32)
    if init is None:
        D = torch.as_tensor(_HE_INIT, device=od.device).expand(
            od.shape[:-2] + (2, 3))
    else:
        D = torch.as_tensor(init, device=od.device).to(torch.float32)
    D = D.clone()

    for _ in range(num_iters):
        # Sparse codes for every pixel under the current dictionary.
        A = nonneg_lasso_k2(od, D[..., None, :, :], regularizer)  # (..., N, 2)
        Aw = A * w[..., None]
        # The two pixel contractions accumulate in float64, as the moment
        # sums of extraction/macenko.py do: a float32 sum over 65k pixels
        # drifts ~1e-5 relative, and the BCD iterations carry it forward.
        C = torch.einsum("...nk,...nl->...kl", Aw.double(),
                         A.double()).float()  # (..., 2, 2)
        B = torch.einsum("...nk,...nc->...kc", Aw.double(),
                         od.double()).float()  # (..., 2, 3)

        # Block coordinate descent over the two stain rows, two sweeps.
        for _sweep in range(2):
            for j in range(2):
                cjj = torch.clamp_min(C[..., j, j], 1e-8)
                resid = B[..., j, :] - (C[..., j, 0, None] * D[..., 0, :]
                                        + C[..., j, 1, None] * D[..., 1, :])
                u = D[..., j, :] + resid / cjj[..., None]
                u = torch.clamp_min(u, 0.0)  # posD
                norm = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
                u = u / torch.clamp_min(norm, 1.0)  # into the unit L2 ball
                # A collapsed (all-zero) stain keeps its old row.
                dead = u.sum(-1, keepdim=True) <= 0.0
                D[..., j, :] = torch.where(dead, D[..., j, :], u)
    return D
