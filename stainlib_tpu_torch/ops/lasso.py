"""Non-negative lasso concentrations: the exact K=2 solver and FISTA.

Port of the JAX package's ``ops/lasso.py:29-118``, which replaces the
reference's ``spams.lasso(X, D, mode=2, lambda1, pos=True)``
(``stainlib/utils/stain_utils.py:69-78``) with the closed-form active-set
solution of ``min_{c >= 0} 0.5 ||x - D c||^2 + lambda ||c||_1`` for two
stains: the same global optimum, branch-free and deterministic.
"""

from __future__ import annotations

import numpy as np
import torch

from stainlib_tpu_torch.ops.colorspace import rgb_to_od
from stainlib_tpu_torch.ops.fdiv import sum3


def nonneg_lasso_k2(od, stain_matrix, regularizer: float = 0.01):
    """Exact concentrations (..., 2) for optical densities (..., 3) against
    row-normalized stain vectors (..., 2, 3) that broadcast with ``od``'s
    batch axes."""
    od = torch.as_tensor(od).to(torch.float32)
    M = torch.as_tensor(stain_matrix, device=od.device).to(torch.float32)
    g11 = sum3(M[..., 0, :] * M[..., 0, :])
    g22 = sum3(M[..., 1, :] * M[..., 1, :])
    g12 = sum3(M[..., 0, :] * M[..., 1, :])
    det = torch.clamp_min(g11 * g22 - g12 * g12, 1e-12)

    b1 = sum3(od * M[..., 0, :]) - regularizer
    b2 = sum3(od * M[..., 1, :]) - regularizer

    # Both stains active: c = G^{-1} b.
    c1_full = (g22 * b1 - g12 * b2) / det
    c2_full = (g11 * b2 - g12 * b1) / det
    ok_full = (c1_full >= 0.0) & (c2_full >= 0.0)
    # One stain active; KKT for the zero coordinate.
    c1_only = torch.clamp_min(b1, 0.0) / torch.clamp_min(g11, 1e-12)
    ok_1 = (b1 >= 0.0) & (g12 * c1_only - b2 >= 0.0)
    c2_only = torch.clamp_min(b2, 0.0) / torch.clamp_min(g22, 1e-12)
    ok_2 = (b2 >= 0.0) & (g12 * c2_only - b1 >= 0.0)

    c1 = torch.where(ok_full, c1_full, torch.where(ok_1, c1_only, 0.0))
    c2 = torch.where(ok_full, c2_full,
                     torch.where(~ok_1 & ok_2, c2_only, 0.0))
    return torch.stack([c1, c2], dim=-1)


def get_concentrations(rgb, stain_matrix, regularizer: float = 0.01):
    """RGB [0,255] (..., H, W, 3) -> concentrations (..., H, W, 2) over all
    pixels (no tissue mask, like ``stain_utils.py:69-78``)."""
    od = rgb_to_od(rgb)
    stain_matrix = torch.as_tensor(stain_matrix, device=od.device)
    if stain_matrix.ndim > 2:
        # Per-image stain matrices: align (..., 2, 3) with (..., H, W, 3).
        stain_matrix = stain_matrix[..., None, None, :, :]
    return nonneg_lasso_k2(od, stain_matrix, regularizer)


def nonneg_lasso_fista(X, D, regularizer: float, num_iters: int = 200):
    """Projected FISTA for ``min_{A>=0} 0.5||X - A D||^2 + reg*||A||_1``
    (``lasso.py:92-118``), the general-K cross-check of
    :func:`nonneg_lasso_k2`. ``X``: (N, P) observations; ``D``: (K, P)
    dictionary rows. Returns (N, K) after a fixed number of iterations, so
    the output is deterministic. The step is ``1 / (trace(D D^T) + 1e-6)``,
    a bound on the quadratic's Lipschitz constant."""
    X = torch.as_tensor(X).to(torch.float32)
    D = torch.as_tensor(D, device=X.device).to(torch.float32)
    G = D @ D.T  # (K, K)
    B = X @ D.T  # (N, K)
    step = 1.0 / (float(torch.trace(G)) + 1e-6)
    A = torch.zeros_like(B)
    Y = A
    t = 1.0
    for _ in range(num_iters):
        A_next = torch.clamp_min(Y - step * (Y @ G - B + regularizer), 0.0)
        t_next = 0.5 * (1.0 + float(np.sqrt(1.0 + 4.0 * t * t)))
        Y = A_next + ((t - 1.0) / t_next) * (A_next - A)
        A, t = A_next, t_next
    return A
